#!/usr/bin/env python3
"""Drive the PyTorch port (codon_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It
  1. prints the card's name and power limit as nvidia-smi gives them;
  2. builds the CUDA kernels from codon_tpu_torch/kernels/csrc with nvcc,
     and prints each kernel's registers, static shared memory and spills
     as ptxas reported them, on one line;
  3. holds each kernel against its plain PyTorch version on the card, in
     float32, bfloat16 and float16, at the main path's shape (batch 4,
     384 x 480 padded, a mask marking 370 x 463 valid, C = 64), at an odd
     shape (2 x 37 x 29, one image half masked) and at the TTA8 path's two
     shapes (16 x 384 x 480, and 16 x 480 x 384 transposed, the masks
     flipped to each corner as the 4 flips place them), spatial_logits
     bitwise; times the kernel, the plain version and, where one exists, a
     single PyTorch call computing the same function, with CUDA events after
     a warmup; and takes each kernel's device time a launch at the main and
     TTA8 shapes from a CUDA graph of back-to-back calls (spatial_logits'
     also at one output tile and at one image, and F.conv2d's too); then
     holds the int8 conv's two kernels, quant_im2col (float32, bfloat16 and
     int8 input; per-channel, per-image and no scale; k 1, 3 and 5) and
     dequant_epilogue (float32, bfloat16 and float16; static and dynamic;
     with and without the mask), bitwise against their plain versions at
     the same four shapes, and times each at the int8 forward's shapes at
     batch 4 (wrapper, plain version, device time a launch from a CUDA
     graph, byte bound), with torch._int_mm's GEMM between them;
  4. runs `python -m codon_tpu_torch.cli eval` in-process, in bfloat16 at
     batch 4, with checkpoints/x4_ship4.npz, on a synthetic Middlebury-shaped
     scale directory (6 images of 463 x 370, 2 of 450 x 375, written with the
     port's own PNG writer), with the kernels' launch counters set to 0 just
     before and read just after; then runs the same eval again in the same
     process, to time it without the first batch's set-up;
  5. runs one float32 forward of the first batch through the kernels and
     through the plain PyTorch stage, and one small float32 forward on the
     card against the same forward on the CPU;
  6. holds the three copy kernels of the HBM copy probe against the
     identity, bitwise, at both of the probe's tiles, at its shape
     (32, 370, 463, 64) bf16 and at (3, 37, 29, 64), each writing into the
     middle of a sentinel-filled buffer whose sentinel must stay intact;
  7. times each copy kernel at both of its tiles, its plain version and
     x.clone() at the probe's shape, with each kernel's design (a ring of
     bulk copies over a persistent grid), grid and chunk size;
  8. runs the probe's sweep (`perf_copy_probe.main`), its RESULT lines
     printed, with the copy kernels' launch counters set to 0 just before
     and read just after, and prints the measured copy ceiling as a share
     of the nominal 3.35 TB/s;
  9. runs `cli eval --tta8 --device-metrics` (bf16, batch 4) on the same
     scale dir with the CAC counters set to 0 just before and read just
     after, holds the card's RMSE and SSIM against the host metrics on the
     PNGs it wrote and against the same tensor metrics on the CPU, and
     runs it again warm, with device and with host metrics, for the rates;
 10. runs float32 TTA8 of the first batch through the kernels and through
     the plain stage;
 11. builds a 2-member `--tta` ensemble (x4_ship4 + x4_holdout2) through
     the cli's own forward and holds it in float32 against the mean of
     its members, then runs it as `cli eval` in bf16 with the CAC counters
     set to 0 just before and read just after;
 12. runs the float32 int8 forward of x4_ship4_qat_static.npz on the first
     batch through the quant kernels and through their plain versions (the
     CAC kernels in both, cuDNN deterministic): bitwise; and one small
     float32 int8 forward on the card against the CPU, in the flip class;
 13. runs `cli eval --dtype int8` (bf16, batch 4) with x4_ship4_qat_static
     with the CAC and quant counters set to 0 just before and read just
     after, then again warm;
 14. runs `cli eval --dtype int8 --tta8 --device-metrics` with the same
     counters and the bf16 TTA8 phase's metric checks;
 15. builds a static + dynamic int8 ensemble (x4_ship4_qat_static +
     x4_ship4_qat) with --tta through the cli's own forward and holds it
     against the mean of its members, then runs it as `cli eval` with the
     counters;
 16. writes x4_ship4.npz as the reference's .pth three ways (a state
     dict; {"epoch", "model"} with DataParallel's module. prefix; a pickled
     stand-in module) and runs `cli eval --ckpt` on each, the CAC counters
     set to 0 just before and read just after each: the same PNGs and
     metrics as the .npz eval, bit for bit (cuDNN deterministic);
 17. runs `cli convert` on each .pth: x4_ship4.npz's arrays again;
 18. runs `cli eval --variant codon_fused` (the merged-tower forward: the
     CAC kernels on the halves of one (N, H, W, 2C) tensor), then with
     --tta8 --device-metrics, with the CAC counters, and the fp32 fused
     forward of the first batch through the kernels against its plain
     stage and against the packed forward;
 19. runs the fp32 int8 fused forward, the quant kernels against their
     plain versions: bitwise;
 20. runs `cli eval --variant codon_fused --dtype int8` (its grouped int8
     convs: a quantize and a windowed gather, GEMM and epilogue a group)
     with the CAC and quant counters;
 21. runs `cli eval --variant rmcr_fuse_rmcr` in bf16 (no CAC launch) and
     int8, with the counters;
 22. runs `cli eval --resume` twice (the second writes the all-done stub),
     `--profile`, `--check-nans` on a checkpoint with one NaN weight (it
     must raise FloatingPointError naming the site), `golden` on the main
     eval's PNGs and `info`;
 23. holds one training step (`train.trainer`, b16 p64 patches of the
     scale dir, x4_ship4's weights, bf16 and fp32) whose forward runs the
     CAC kernels through `CacStageFunction` against the same step with the
     plain stage: loss and every gradient leaf within TRAIN_TOLS, every
     leaf the forward reads with a gradient, and 5 launches of each CAC
     kernel in the step (the forward's; none in the backward);
 24. runs `cli train` (bf16, b16 p64) from x4_ship4 for 30 steps with
     warmup, clip-norm, EMA and checkpoints every 10 steps, the CAC
     counters set to 0 just before and read just after (5 each a step);
     runs it again interrupted after its step-10 checkpoint and resumed:
     the same batches, bitwise, and the final parameters within
     RESUME_BOUND_LRS x lr a step; runs `--qat-static` from
     x4_ship4_qat_static and scores its output with `cli eval --dtype
     int8`; and runs 5 steps on the scale dir without input_depth/
     (synthesized degradation); then one batch-1 bf16 step of `codon`
     (the CAC kernels, 5 launches each);
 25. times a training step at b16 p64 in bf16 and fp32 (CUDA events), split
     into forward, backward and optimizer, and the host sampler's ms a
     batch;
 26. profiles 10 steps of the loop `cli train` runs (prefetch thread,
     pinned copy, step) with torch.profiler: the device's idle share;
 27. runs each of the 27 nets of the ablation zoo (`zoo:<name>`, its own
     init from a seed) at the zoo's cell shape (batch 4: two scenes of 463
     x 370 and two of 450 x 375 padded to 480 x 384, masked) in fp32 and
     bf16: finite, bf16 within ZOO_BF16_REL of fp32, no kernel launched;
     for the nets with a global reduction over pixels, each image of the
     masked batch against the image alone; the device ms of a forward in
     each dtype;
 28. holds the zoo's CODONNet entry on x4_ship4 (through the reference's
     state dict and generic_state_dict_to_flat) against `codon` with the
     CAC kernels, fp32 and bf16, with the CAC counts (none on the zoo path);
 29. runs `cli eval --variant zoo:<net> --tta8 --device-metrics` (bf16)
     for three nets, with the counts;
 30. for the two zoo nets with narrow int8 sites, the fp32 int8 forward
     through the quant kernels against their plain versions (bitwise), and
     `cli eval --dtype int8` with the quant kernels' counts against the
     launches each conv call should make, the padded narrow sites included;
 31. runs `cli train --variant zoo:<net>` (bf16, b16 p64) for two nets:
     falling losses, the unread leaves moved by the weight decay alone;
 32. runs the serving matrix (`codon_tpu_torch.export_matrix --load-check`:
     static int8 x4, x8, x16 and x4 with TTA4 and TTA8 at 463 x 370, bf16
     compute, from checkpoints/x{4,8,16}_qat_static2.npz) into .pt2 files
     in a temporary directory, and `cli export` of codon bf16 with a mask
     input (480 x 384) and of codon fp32 (463 x 370) from x4_ship4; loads
     all seven artifacts in a fresh process that cannot import the model
     code (nor jax, codon_tpu, cv2, PIL), which answers batches of 1, 2 and
     4 of the first batch: bitwise equal to the live forward of the same
     configuration here, cuDNN deterministic in both (fp32, whose process
     starts with TF32 on, within SERVE_FP32_TOL), with the same CAC and
     quant launches request by request; prints each artifact's steady b4
     call and b1 latency beside the live forward's;
 33. the mesh (`codon_tpu_torch.parallel`), 4 gloo ranks sharing the one
     card, this process rank 0: `cli eval --tile-devices 2 --dp-devices 2
     --dist-backend gloo --tta8 --device-metrics` in bf16 and static int8
     against the single-device evals of phases 9 and 14 (each image's PNG
     within MESH_CLI_PNG, bf16 and int8 each in its own class, RMSE within
     the RMS of the PNGs' difference, SSIM within 0.01; the cli's mesh
     banner, and from its --json summary every rank's CAC and quant
     launches and collective calls); `make_tiled_forward` of x4_ship4
     on the first batch (b4, 384 x 480, masked) at dp x sp = 1x2, 1x4,
     2x1 and 2x2, bf16 (in the bf16 class of `mesh_bf16_class`) and fp32
     (MESH_FP32_TOL) against the single-device forward, fp32 kernels
     against the plain stage at 1x4 (FWD_TOL); static int8
     (x4_ship4_qat_static, scales through scales_factory) and dynamic
     (x4_ship4_qat, Int8ShardedOps) at 2x2 and 1x4 against unsharded, in
     the flip class; codon_fused and rmcr_fuse_rmcr at 1x2; one 1480 x
     1852 frame (the first scene, 4x in each axis), b1 bf16, at 1x2
     against untiled, and `tile_stitch_infer` on it (mean |d| < 5e-3);
     each with every rank's CAC and quant launches (counters set to 0 just
     before, read just after, from every rank) and rank 0's collective
     tallies, and its wall time (CUDA events on rank 0) beside the
     single-device forward's: ranks sharing one H100 over gloo, not
     multi-GPU speed; NCCL's refusal of 2 ranks on 1 card, and its
     one-rank group running the sharded forward; the haloed quant_im2col
     and int8_conv against their plain versions at the sp = 2 shard's
     sites (int8 input, and bf16 on a per-image scale; bitwise), and the
     two routes of a haloed int8 conv (the gather's halo rows, or SAME +
     crop), timed;
 34. trains over the same 4 gloo ranks (`make_train_step(..., mesh=)`),
     x4_ship4's weights on cli train's batch (b16 p64) at dp x sp = 2x2,
     1x4 and 2x1 in bf16 and fp32, one large-patch form (b4 p256 at 1x4,
     bf16), and static and dynamic QAT (x4_ship4_qat_static's act_scales,
     x4_ship4_qat) at 2x2: each form's loss and summed gradient against
     the single-device step's (MESH_TRAIN_TOLS; QAT MESH_QAT_LOSS_RTOL),
     its parameters after one step (within MESH_TRAIN_PARAM_LRS x lr),
     5 launches of each CAC kernel a step on every rank of the mesh and
     none in the backward, the CAC stage called on shards only (sp > 1),
     every rank's collective tallies a step, the replicas bitwise equal
     on every rank after MESH_TRAIN_STEPS steps, and the wall ms a step
     beside the single-device step's (ranks sharing one H100 over gloo);
     then a one-rank NCCL group's step against the single-device one;
 35. the ablation zoo over 4 gloo ranks sharing the card: every one of
     the 27 nets (its own init) in fp32 at b2 (463 x 370 and 450 x 375
     padded to 480 x 384, masked) at 1x4 against its single-device forward
     (MESH_FP32_TOL); basenet_nlar, rmcr_fuse_rmcr_rcan and
     rmcr_fuse_rmcr_eccv at b4 in bf16 at 2x2 and 1x4 (against the fp32
     forward, `mesh_bf16_class(vs_fp32=True)`) and in dynamic int8 at 2x2,
     bf16 and fp32 (bitwise the same forward through the plain quant
     versions; fp32 against the unsharded int8 forward in the flip class
     or within the move of its own input's 1e-6 change, and on a b4 32x24
     frame in the flip class; every rank's quant launches those of its
     shard; fp32 also against the unsharded forward taken a dp block at
     a time, and the form whose pools gather the image and reduce it in
     the single-device order against that, in the flip class: ROADMAP
     C5), and their
     sharded training step at 2x2 (b16 p64, bf16 and fp32: TRAIN_TOLS,
     params within 2 lr, replicas bitwise after 2 steps); `cli eval
     --variant zoo:rmcr_fuse_rmcr_rcan --tile-devices 2 --dp-devices 2
     --tta8 --device-metrics` against phase 29's eval (MESH_CLI_PNG);
     no rank launches a CAC kernel or calls the CAC stage; each form's
     wall a forward or a step beside single-device;
 36. codon_fused training: its kernel step against its plain-stage step
     (TRAIN_TOLS, fp32 and bf16) and, fp32, against codon's step on
     x4_ship4 (5 launches of each CAC kernel a step, none in the
     backward), both steps timed over TIME_ITERS steps; `cli train
     --variant codon_fused` from x4_ship4 (bf16 and fp32) with the
     counts; one sharded bf16 step at 2x2 against its single step;
 37. the tools: `codon_tpu_torch.soup` of x4_ship4 and x4_holdout2 and a
     bf16 `cli eval` of the soup; `codon_tpu_torch.sc_cond_probe` on three
     scenes with x4_holdout_sc; a PatchSampler with pyramid=PYRAMID (its
     levels' build ms on the host) and one bf16 step on a batch it draws;
 38. `codon_tpu_torch.entry`'s forward (1 x 370 x 463, bf16, 5 launches
     of each CAC kernel); `codon_tpu_torch.tta_shift_probe` with
     x4_holdout2 over the scale dir (finite rows with the JAX script's
     JSON keys, 5 launches a TTA4 forward, 5 shifts x 2 batches); and
     `codon_tpu_torch.ttt_probe --tta` on three scenes, 20 steps each
     (finite rows with the JAX script's keys, 5 launches a scoring
     forward and a step, none in a backward), then its second scene
     alone, whose score before fine-tuning must be the same;
 39. prints the card's line again, the kernels' JSON line (eight kernels;
     each CAC and quant kernel's launches_by_path with the mesh paths, by
     rank), then the contract line {"ok": true, "device": {...}} as the
     last line of its output.

Phase 3 holds the CAC kernels at the training path's shape too (16 x 64 x
64, every pixel valid). It also holds cac_stats and cac_apply against
their plain versions on the halves of a (N, H, W, 2C) tensor (a tower
pitch of 2C) at the main, TTA8 and training shapes, and quant_im2col and dequant_epilogue on each group's
channel and output window at every grouped shape of the b4 codon_fused
forward, bitwise, each timed beside the contiguous kernel. It holds
cac_stats to its own bits: two eager calls, and a CUDA graph of one call
replayed twice, at the main, odd and training shapes, one launch a call;
and prints each CAC kernel's device time beside its bound as a share of it.

Any failed check raises: the script then exits non-zero and prints no
result. It also exits non-zero, printing nothing on stdout, without a CUDA
device or outside a checkout.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "x4_ship4.npz")
# the ensemble's second member: a holdout-trained checkpoint of variant codon
CKPT2 = os.path.join(REPO, "checkpoints", "x4_holdout2.npz")
# the static-int8 deployment: QAT weights with 18 calibrated act_scales
# sites, and the same weights' dynamic-scale sibling (no act_scales)
CKPT_INT8 = os.path.join(REPO, "checkpoints", "x4_ship4_qat_static.npz")
CKPT_INT8_DYN = os.path.join(REPO, "checkpoints", "x4_ship4_qat.npz")

# H100 SXM peaks (NVIDIA's data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12        # outside the tensor cores
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core operations
# fp32 instructions a second: an FMA counts as 2 flops, a lone multiply or
# add is one instruction all the same
FP32_INSNS_PER_S = FP32_FLOPS_PER_S / 2
# spatial_logits rounds each of a tap's 2 multiplies and 2 adds on its own
LOGIT_INSNS_PER_TAP = 4
GRAPH_CALLS = 20            # back-to-back calls in a device-time graph

# kernel-against-plain tolerances, |kernel - plain| <= atol + rtol * |plain|:
# float32 as tests/test_kernels.py holds the Pallas kernels (only the order
# of float32 sums differs); bfloat16 and float16 two ulps of their 8- and
# 11-bit significands (a pooled mean or a gate value rounded once to the
# activation type may land one ulp apart when its float32 value differs in
# the last bits), with the same amount as atol for values near zero. The
# channel sums and maxes of cac_stats are float32 results over the same
# rounded inputs in every activation type, so they are held at the float32
# tolerance whatever that type is.
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -6, 2 ** -6),
        "float16": (2 ** -9, 2 ** -9)}
# float32 forward, kernels against the plain stage: TF32 off, only the
# order of float32 sums differs
FWD_TOL = 1e-4
# float32 forward on the card against the CPU: the model-parity tolerance
# of tests/test_model_parity.py (cuDNN and the CPU sum in other orders)
CPU_TOL = 5e-4

# TTA8 eval on the card with --device-metrics: RMSE against the host's
# on the written PNGs within 1e-3 (tests/test_metrics.py: float32 on the
# card); SSIM within 0.03, the JAX package's documented bound for the
# normalized-convolution border of padded images (tests/test_metrics.py);
# the same tensor metrics on the CPU on the same bytes within 1e-5 (float32
# on both sides, sums in another order)
RMSE_HOST_TOL = 1e-3
SSIM_HOST_TOL = 0.03
METRIC_CPU_TOL = 1e-5

DEVICE = "cuda"
MAIN_SHAPE = (4, 384, 480, 64)
MAIN_VALID = [(370, 463)] * 4
ODD_SHAPE = (2, 37, 29, 64)
ODD_VALID = [(37, 29), (19, 15)]


def tta_valid(sizes):
    """The valid region (h, w, flipped down, flipped right) of each image
    of a batched TTA forward over a batch of the given sizes: the flips id,
    V, H, HV of `models/tta.py`, each over the whole batch."""
    return [(h, w, fv, fh) for fv, fh in ((0, 0), (1, 0), (0, 1), (1, 1))
            for h, w in sizes]


# where the TTA8 eval of the main path gives the CAC kernels their inputs:
# a batch of 4 (the synthetic dir's second batch holds both scene sizes)
# as the 4 flips at 384 x 480, then transposed at 480 x 384
TTA_SIZES = [(370, 463)] * 2 + [(375, 450)] * 2
TTA_SHAPE = (16, 384, 480, 64)
TTA_VALID = tta_valid(TTA_SIZES)
TTA_T_SHAPE = (16, 480, 384, 64)
TTA_T_VALID = tta_valid([(w, h) for h, w in TTA_SIZES])
# where cli train gives them: a batch of 16 patches of 64 x 64, every
# pixel valid (the sampler's mask is all ones)
TRAIN_SHAPE = (16, 64, 64, 64)
TRAIN_VALID = [(64, 64)] * 16
STAGE_CASES = ((MAIN_SHAPE, MAIN_VALID), (ODD_SHAPE, ODD_VALID),
               (TTA_SHAPE, TTA_VALID), (TTA_T_SHAPE, TTA_T_VALID),
               (TRAIN_SHAPE, TRAIN_VALID))
# the copy probe's shape (scripts/perf_pallas_probe.py), bf16, and a small
# one whose last tile is ragged for every tile; (name, view, the two tiles
# of the probe's sweep) for each kernel
PROBE_SHAPE = (32, 370, 463, 64)
RAGGED_COPY_SHAPE = (3, 37, 29, 64)
COPY_KERNELS = (("copy4d", "4d", (64, 128)), ("copyflat", "flat", (64, 8)),
                ("copy3d", "3d", (512, 64)))
COPY_SENTINEL = -7.0        # the inputs lie in [0, 1)
COPY_ITERS = 50             # timed calls a copy line, ~25 ms of copying
COPY_GUARD = 4096           # sentinel elements before and after the output
# the synthetic scale dir: Middlebury's 463 x 370 and a second size that
# pads to the same 480 x 384
SCENES = [(370, 463)] * 6 + [(375, 450)] * 2
# a whole int8 forward, card against CPU at 37 x 29: the flip class of
# tests/test_torch_quant.py (one int8 code that flips at a rounding
# boundary cascades; JAX's static int8 forward moves by mean 0.0028 / max
# 0.036 when its input moves by 1e-6): mean |d| <= 0.01, max <= 0.1
INT8_CPU_BOUNDS = (0.01, 0.1)
# the quantized conv calls of one forward, (k, C_in, calls): conv_input(_c),
# packed_d/c x 5, conv3/conv6 x 5, confuse(_c) x 5, conv7, packed_f x 3,
# conv10 x 3, confuse_fuse x 3, conv11
INT8_CONVS = ((3, 64, 2), (5, 64, 10), (5, 128, 10), (1, 128, 10),
              (3, 128, 1), (5, 64, 3), (5, 128, 3), (1, 128, 3), (3, 64, 1))
# the static backend's handoffs of one forward, each a quant_im2col call
# at k = 1: 13 precommits (packed_d and packed_c before each of the 5
# stages, packed_f before each of the 3 fuse stages) and 13 roundtrips
# (the 2 stems, the 2 gates of each of the 5 stages, conv7's output)
INT8_HANDOFFS = 26
# the quantized conv calls of one codon_fused forward, (k, C_in, groups,
# C_out, calls): the grouped conv_input+conv_input_c, then conv1+conv5,
# conv2+conv4, conv3+conv6 and confuse+confuse_c in each of the 5 stages;
# conv7, conv8, conv9, conv10 and confuse_fuse x 3, conv11 ungrouped. The
# merged-tower forward has no handoffs.
FUSED_INT8_CONVS = ((3, 128, 2, 128, 1), (3, 128, 2, 128, 5),
                    (5, 128, 2, 128, 5), (5, 256, 2, 256, 5),
                    (1, 256, 2, 128, 5), (3, 128, 1, 64, 1),
                    (5, 64, 1, 64, 3), (3, 64, 1, 64, 3), (5, 128, 1, 128, 3),
                    (1, 128, 1, 64, 3), (3, 64, 1, 64, 1))
# fp32 merged-tower forward against the packed one on the card: the
# tolerance tests/test_model_parity.py holds the JAX package's two forms to
FUSED_TOL = (2e-4, 1e-3)
# the three forms of a reference .pth that phase 16 writes
PTH_KINDS = ("state_dict", "epoch_model_module_prefix", "full_module")
# training (phases 23-26): cli train's defaults, batches of 16 patches of
# 64 x 64
TRAIN_BATCH, TRAIN_PATCH = 16, 64
TRAIN_STEPS = 30
TIME_ITERS = 10             # timed training steps (and profiled ones)
# one training step with the CAC stage through the kernels against the
# same step with the plain stage, same batch and weights: (loss rtol, the
# worst leaf's max |d| over its max |g|, the gradient tree's relative L2
# distance). fp32, TF32 off: the kernels sum in another order, ~1e-7 of a
# value, and a pre-activation that crosses 0 on one side only moves its
# ReLU's whole gradient path, so single elements may move by a percent of
# their leaf's max while the tree moves by ~1e-4: 1e-5 / 1e-2 / 1e-3.
# bf16: the plain stage pools, runs the MLP and the gates in bf16 where the
# kernels keep float32 and round the gate once, a bf16 ulp apart that
# cascades: 1e-2 / 0.25 / 0.1, and the kernel step no more than
# BF16_CLASS times farther from the fp32 step's gradient than the plain
# bf16 step is (bf16's own error sets the scale)
TRAIN_TOLS = {"fp32": (1e-5, 1e-2, 1e-3), "bf16": (1e-2, 0.25, 0.1)}
BF16_CLASS = 1.5
# a resumed run against the uninterrupted one: the batches are bitwise
# equal; cuDNN may pick non-deterministic backward-weight algorithms (the
# trainer leaves its defaults, for speed), so the gradients may differ in
# their last bits, and an element whose gradient's sign then differs moves
# by up to about 2 lr an Adam step: params within 2 x 1e-4 (the peak lr) a
# step after the resume
RESUME_BOUND_LRS = 2
# the ablation zoo (phases 27-31): its cell batch (the scale dir's second
# batch: two scene sizes padded to 480 x 384, masked), its nets' own init
# from ZOO_SEED
ZOO_SIZES = [(370, 463), (375, 450)]
ZOO_SEED = 0
# the nets whose forward reduces over pixels (masked channel pools, CGNL's
# dot and GroupNorm, CALayer, CBAM, the depth-only gates): each image of
# the masked batch against the image alone, fp32, max |d| within the
# parity tolerance atol + rtol x the image's max |y|: cuDNN sums the
# padded shape in another order, and random-init outputs are small
# differences of large activations
ZOO_GLOBAL = ("basenet_nlar", "basenet_non", "basenet_non2", "basenet_non3",
              "basenet_non_corr", "basenet_non_cat", "rmcr_fuse_rmcr_rcan",
              "rmcr_fuse_rmcr_eccv", "rmcr_fuse_rmcr_cross2")
ZOO_IMAGE_TOL = (5e-4, 1e-3)
# bf16 forward against fp32 at random init: the mean |d| over valid pixels
# within 25% of the fp32 output's mean |y|. Random-init outputs are small
# differences of large activations (the MC nets' reach ~500), so bf16's
# rounding is amplified by a net-dependent amount: at 4 x 64 x 64 masked
# on the CPU the JAX package's jitted bf16 zoo forwards read up to 2.8% of
# it and the port's (each op rounded to bf16) up to 3.5%; on the card at
# the cell shape the two-mask CAC net (..._advise1_parall) read 9.0%
ZOO_BF16_REL = 0.25
# the zoo's CODONNet entry against codon on x4_ship4: fp32 FWD_TOL; bf16
# the port's bf16 forward tolerance (tests/test_torch_model.py, atol 0.05
# of a [0, 1] depth map)
ZOO_CODON = "rmcr_fuse_rmcr_cross_only_corss_advise1"
ZOO_CODON_BF16_ATOL = 0.05
ZOO_EVAL_NETS = ("basenet_nlar", "rmcr_fuse_rmcr_eccv", "rmcr_fuse_rmcr_rcan")
ZOO_INT8_NETS = ("basenet_nlar", "rmcr_fuse_rmcr_rcan")
ZOO_TRAIN_NETS = ("rmcr_fuse_rmcr_rcan", "basenet_nlar")
# zoo training: the mean loss of the last half of the steps must lie below
# the first half's. Not the first step's: basenet_nlar's CGNL heads start
# with a zero `z`, so their GroupNorm passes nothing at step 1 and unit
# variance from step 2, and its loss rises before it falls
ZOO_TRAIN_STEPS = 12
ZOO_WEIGHT_DECAY = 0.01
# export and serve (phase 32): what a serving process must not need (the
# model code, and what the card's machine lacks), the request batches each
# artifact answers, and the fp32 artifact's bound against the live fp32
# forward (both TF32-off; only a reordered sum could move a bit)
SERVE_BLOCKED = ("codon_tpu_torch.models", "codon_tpu_torch.quant_ops",
                 "codon_tpu_torch.cli", "jax", "codon_tpu", "cv2", "PIL")
SERVE_BATCHES = (1, 2, 4)
SERVE_FP32_TOL = 1e-6
# file:line of each kernel's pallas_call
REPLACES = {"cac_stats": "codon_tpu/kernels/cac.py:143",
            "spatial_logits": "codon_tpu/kernels/cac.py:193",
            "cac_apply": "codon_tpu/kernels/cac.py:239",
            "copy4d": "scripts/perf_pallas_probe.py:65",
            "copyflat": "scripts/perf_pallas_probe.py:75",
            "copy3d": "scripts/perf_pallas_probe.py:85",
            "quant_im2col": "no Pallas source: XLA's fused int8 quantize / "
                            "conv epilogue, codon_tpu/quant_ops.py:103-131, "
                            "346-370",
            "dequant_epilogue": "no Pallas source: XLA's fused int8 quantize "
                                "/ conv epilogue, codon_tpu/quant_ops.py:"
                                "103-131, 346-370"}


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Failed(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_mask(shape, valid):
    """(N, H, W, 1) float32 validity mask. valid: per image (h, w) at the
    top left, or (h, w, flipped down, flipped right)."""
    import torch
    n, h, w = shape[:3]
    mask = torch.zeros((n, h, w, 1), device=DEVICE)
    for i, (vh, vw, *flip) in enumerate(valid):
        fv, fh = flip or (0, 0)
        rows = slice(h - vh, h) if fv else slice(0, vh)
        cols = slice(w - vw, w) if fh else slice(0, vw)
        mask[i, rows, cols] = 1.0
    return mask


def make_stage_inputs(shape, valid, dtype, seed):
    """Towers zero on padding, as masked convs leave them; valid as in
    `make_mask`."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mask = make_mask(shape, valid)
    towers = [torch.randn(shape, generator=g, device=DEVICE) * mask
              for _ in range(4)]
    gate = torch.rand((n, 1, c), generator=g, device=DEVICE)
    sp_w = torch.randn((5, 5, 2, 1), generator=g, device=DEVICE) * 0.2
    logits = torch.randn((n, h, w), generator=g, device=DEVICE)
    return ([t.to(dtype).contiguous() for t in towers], mask.to(dtype),
            gate, sp_w, logits.to(dtype))


def max_err(got, want, atol, rtol):
    """-> (max |got - want|, whether every element is within tolerance)."""
    import torch
    err, ok = 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ok = ok and bool(torch.all(d <= atol + rtol * w.abs()))
    return err, ok


def check_kernels(kc):
    """Every kernel and dtype at every shape a driven path gives it, masks
    placed as that path places them: -> {name: [check, ...]}."""
    import torch
    checks = {k: [] for k in ("cac_stats", "spatial_logits", "cac_apply")}
    seed = 0
    for dname, (atol, rtol) in TOLS.items():
        dtype = getattr(torch, dname)
        for shape, valid in STAGE_CASES:
            seed += 1
            (out, out_c, inp, inp_c), mask, gate, sp_w, logits = \
                make_stage_inputs(shape, valid, dtype, seed)
            npix = shape[1] * shape[2]
            for m in (mask, None):
                got = kc.cac_stats(out, out_c, m)
                want = kc.cac_stats_plain(out, out_c, m)
                # the sums compared as means: the stage divides them by the
                # pixel count, and a float32 sum over n pixels carries
                # rounding that grows with n
                err_f32, ok_f32 = max_err(
                    (got[0] / npix, got[1]), (want[0] / npix, want[1]),
                    *TOLS["float32"])
                err, ok = max_err(got[2:], want[2:], atol, rtol)
                checks["cac_stats"].append(
                    {"dtype": dname, "shape": list(shape),
                     "mask": m is not None, "max_abs_err": max(err, err_f32),
                     "ok": ok and ok_f32})
            _, _, cmax, cmean = kc.cac_stats_plain(out, out_c, mask)
            got = kc.spatial_logits(cmax, cmean, sp_w)
            want = kc.spatial_logits_plain(cmax, cmean, sp_w)
            # the kernel rounds every multiply and add as the plain version
            # does, in its order: the same bits
            err, _ = max_err([got], [want], atol, rtol)
            same = torch.equal(got, want)
            checks["spatial_logits"].append(
                {"dtype": dname, "shape": list(shape), "max_abs_err": err,
                 "bitwise": same, "ok": same})
            err, ok = max_err(
                kc.cac_apply(out, out_c, inp, inp_c, gate, logits),
                kc.cac_apply_plain(out, out_c, inp, inp_c, gate, logits),
                atol, rtol)
            checks["cac_apply"].append(
                {"dtype": dname, "shape": list(shape), "max_abs_err": err,
                 "ok": ok})
    return checks


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 10) -> float:
    """Device time of one call of `fn`: `calls` back-to-back calls captured
    in a CUDA graph after a warm call (so the library is loaded and the
    allocator has its blocks), the graph replayed after a warmup and timed
    with CUDA events. No host time of a launch is in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(nbytes, flops):
    """-> (least ms, "bytes" or "operations"): bytes over the memory rate
    or fp32 operations over the fp32 rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_rows(kc, shape, valid, seed):
    """Each CAC kernel at the stage shape `shape`, bfloat16 (the eval
    default): -> {name: {kern, plain, library (a call or None), shape (of
    the kernel's first input), bound (ms, by), floor (fp32 instruction
    floor ms, or None)}}."""
    import torch
    import torch.nn.functional as F
    n, h, w, c = shape
    dtype = torch.bfloat16
    (out, out_c, inp, inp_c), mask, gate, sp_w, logits = \
        make_stage_inputs(shape, valid, dtype, seed=seed)
    _, _, cmax, cmean = kc.cac_stats_plain(out, out_c, mask)
    s = out.element_size()
    nhw, nhwc = n * h * w, n * h * w * c
    k = sp_w.shape[0]
    stack = torch.stack([cmax, cmean], 1)                      # (N,2,H,W)
    w_conv = sp_w.permute(3, 2, 0, 1).to(dtype).contiguous()   # (1,2,k,k)
    return {
        "cac_stats": dict(
            kern=lambda: kc.cac_stats(out, out_c, mask),
            plain=lambda: kc.cac_stats_plain(out, out_c, mask),
            library=None, shape=list(shape), floor=None,
            # read both towers and the mask; write two maps and 2 x (N,2C)
            bound=bound(2 * nhwc * s + nhw * s + 2 * nhw * s
                        + 2 * n * 2 * c * 4,
                        # per element: channel sum + max, pixel sum + max
                        2 * nhwc * 4)),
        "spatial_logits": dict(
            kern=lambda: kc.spatial_logits(cmax, cmean, sp_w),
            plain=lambda: kc.spatial_logits_plain(cmax, cmean, sp_w),
            library=lambda: F.conv2d(stack, w_conv, padding=k // 2),
            shape=[n, h, w],
            bound=bound(3 * nhw * s + 2 * k * k * 4, nhw * 4 * k * k),
            floor=nhw * k * k * LOGIT_INSNS_PER_TAP / FP32_INSNS_PER_S * 1e3),
        "cac_apply": dict(
            kern=lambda: kc.cac_apply(out, out_c, inp, inp_c, gate, logits),
            plain=lambda: kc.cac_apply_plain(out, out_c, inp, inp_c, gate,
                                             logits),
            library=None, shape=list(shape), floor=None,
            # 4 tower reads, 2 writes, the logits and the gate
            bound=bound(6 * nhwc * s + nhw * s + n * c * 4,
                        # per element: gate x sigmoid, 2 multiplies, 2 adds
                        5 * nhwc)),
    }


def time_kernels(kc):
    """bfloat16 (the eval default). At the main-path shape: the wrapper's
    time over back-to-back calls, the plain version's and the library
    call's. At the main and both TTA8 shapes: the device time a launch
    (`graph_ms`), the library call's too. -> {name: timings}."""
    import torch
    out_rows = {}
    for shape, valid in (STAGE_CASES[0],) + STAGE_CASES[2:]:
        rows = kernel_rows(kc, shape, valid, seed=99)
        for name, r in rows.items():
            bound_ms, bound_by = r["bound"]
            lib = r["library"]
            if shape == MAIN_SHAPE:
                out_rows[name] = {
                    "ms": time_ms(r["kern"]), "plain_ms": time_ms(r["plain"]),
                    "library_ms": time_ms(lib) if lib is not None else None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "by_shape": []}
            by = {"shape": r["shape"], "device_ms": graph_ms(r["kern"]),
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None, "library_device_ms": None}
            by["share_of_bound"] = bound_ms / by["device_ms"]
            if r["floor"] is not None:
                by["insn_floor_ms"] = r["floor"]
            if lib is not None:
                by["library_ms"] = time_ms(lib)
                by["library_device_ms"] = graph_ms(lib)
            out_rows[name]["by_shape"].append(by)
        del rows
        torch.cuda.empty_cache()
    for row in out_rows.values():
        row["device_ms"] = row["by_shape"][0]["device_ms"]
    out_rows["spatial_logits"]["small"] = logits_small(kc)
    return out_rows


def logits_small(kc):
    """spatial_logits' device time a launch where there is almost nothing
    to compute: one 64 x 32 output tile (a launch, one block's staging and
    drain) and one 384 x 480 image (one block on each of 72 SMs). ->
    [{shape, device_ms}]."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for shape in ((1, 32, 64), (1, 384, 480)):
        cmax, cmean = (torch.randn(shape, generator=g, device=DEVICE)
                       .to(torch.bfloat16) for _ in range(2))
        sp_w = torch.randn((5, 5, 2, 1), generator=g, device=DEVICE)
        rows.append({"shape": list(shape), "device_ms": graph_ms(
            lambda: kc.spatial_logits(cmax, cmean, sp_w))})
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def write_scale_dir(root: str, seed: int = 0):
    """A Middlebury-shaped scale dir: smooth piecewise-planar ground truth,
    its x4 box-down / nearest-up degradation as the depth input, and a
    textured guidance image that shares the depth edges."""
    import numpy as np
    from codon_tpu_torch.data.io import imwrite_gray
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(SCENES):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        label = 60 + 120 * (xx / w) + 40 * (yy / h)
        for _ in range(6):
            y0, x0 = rng.randint(0, h * 7 // 8), rng.randint(0, w * 7 // 8)
            label[y0:y0 + rng.randint(h // 16, h // 3),
                  x0:x0 + rng.randint(w // 16, w // 3)] = rng.uniform(30, 250)
        label = np.clip(label, 1, 255).astype(np.uint8)
        hs, ws = h // 4 * 4, w // 4 * 4
        low = label[:hs, :ws].reshape(hs // 4, 4, ws // 4, 4).mean((1, 3))
        depth = label.copy()
        depth[:hs, :ws] = np.repeat(np.repeat(low, 4, 0), 4, 1)
        color = np.clip(label.astype(np.float64) * 0.6 +
                        rng.normal(0, 20, (h, w)) + 40, 0, 255)
        name = f"scene{i}.png"
        imwrite_gray(os.path.join(root, "input_depth", name), depth)
        imwrite_gray(os.path.join(root, "input_color", name),
                     color.astype(np.uint8))
        imwrite_gray(os.path.join(root, "input_label", name), label)
    return len(SCENES)


def eval_once(data: str, out: str, jpath: str, batch: int, extra=(),
              ckpt: str = CKPT, dtype: str = "bf16", variant: str = "codon"):
    """One in-process `cli eval`, bf16 (or `dtype`) -> (summary, wall
    seconds). ckpt None: the variant's own init (the cli's seed 0)."""
    from codon_tpu_torch import cli
    t0 = time.time()
    rc = cli.main(["eval", "--scale", "4", "--data-dir", data,
                   *(["--ckpt", ckpt] if ckpt else []),
                   "--variant", variant, "--batch",
                   str(batch), "--dtype", dtype, "--out", out,
                   "--json", jpath, "--device", DEVICE, *extra])
    wall = time.time() - t0
    need(rc == 0, f"cli eval returned {rc}")
    with open(jpath) as f:
        return json.load(f), wall


def run_main_path(kc, tmp: str):
    data = os.path.join(tmp, "CODON_X4")
    n_images = write_scale_dir(data)
    batch = 4
    kc.reset_launches()
    summary, wall = eval_once(data, os.path.join(tmp, "out"),
                              os.path.join(tmp, "eval.json"), batch)
    counts = kc.launches()
    need(summary["images"] == n_images and
         len(summary["per_image"]) == n_images,
         f"eval scored {len(summary['per_image'])} of {n_images} images")
    for key in ("mean_rmse", "mean_ssim"):
        need(summary[key] is not None and math.isfinite(summary[key]),
             f"{key} is not finite: {summary[key]}")
    for row in summary["per_image"]:
        need(math.isfinite(row["rmse"]) and math.isfinite(row["ssim"]),
             f"non-finite metric for {row['name']}")
    outs = sorted(os.listdir(os.path.join(tmp, "out")))
    need(len(outs) == n_images, f"{len(outs)} output PNGs, {n_images} "
         f"images")
    batches = -(-n_images // batch)
    for name, count in counts.items():
        need(count == 5 * batches,
             f"{name} launched {count} times in {batches} forward batches; "
             f"expected {5 * batches} (5 CAC stages a forward)")
    # the same eval again in this process: cuDNN's and the kernels'
    # first-call set-up is paid, so its end-to-end rate is the forward plus
    # the host layers (PNG decode and writes, RMSE, SSIM)
    warm, _ = eval_once(data, os.path.join(tmp, "out_warm"),
                        os.path.join(tmp, "eval_warm.json"), batch)
    need(warm["images"] == n_images and
         all(math.isfinite(warm[k]) for k in ("mean_rmse", "mean_ssim")),
         "the warm eval did not score every image")
    return summary, warm, counts, wall, data


# ---------------------------------------------------------------------------
# phase 5: paths against each other
# ---------------------------------------------------------------------------

def compare_paths(data: str):
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.data.io import discover_pairs, load_sample
    from codon_tpu_torch.data.pipeline import make_batch
    from codon_tpu_torch.models.codon_net import CodonConfig, codon_forward

    tree = load_npz(CKPT)
    params = params_from_numpy(tree, DEVICE)
    names = discover_pairs(data)[:4]
    b = make_batch([load_sample(data, n) for n in names], 32, DEVICE,
                   fixed_hw=MAIN_SHAPE[1:3])
    cfg = CodonConfig(dead_heads=True)
    kern = codon_forward(params, b.depth, b.color, mask=b.mask,
                         cfg=dataclasses.replace(cfg, cac_impl="kernel"))
    plain = codon_forward(params, b.depth, b.color, mask=b.mask,
                          cfg=dataclasses.replace(cfg, cac_impl="torch"))
    need(bool(torch.isfinite(kern).all()), "non-finite fp32 forward")
    d_paths = float((kern - plain).abs().max())
    need(d_paths <= FWD_TOL, f"fp32 forward, kernels vs plain stage: max "
         f"abs diff {d_paths} > {FWD_TOL}")

    g = torch.Generator().manual_seed(1)
    d = torch.rand((1, 37, 29, 1), generator=g)
    c = torch.rand((1, 37, 29, 1), generator=g)
    on_card = codon_forward(params, d.to(DEVICE), c.to(DEVICE),
                            cfg=cfg).cpu()
    on_cpu = codon_forward(params_from_numpy(tree, "cpu"), d, c, cfg=cfg)
    d_cpu = float((on_card - on_cpu).abs().max())
    need(d_cpu <= CPU_TOL, f"fp32 forward, card vs CPU: max abs diff "
         f"{d_cpu} > {CPU_TOL}")
    return d_paths, d_cpu


# ---------------------------------------------------------------------------
# phases 6-8: the copy kernels of the HBM copy probe
# ---------------------------------------------------------------------------

def check_copies(kcopy, probe):
    """Every copy kernel at both of the probe's tiles, at the probe's shape
    and at a small ragged one: the output, written into the middle of a
    sentinel-filled buffer, equals the input bitwise, and the sentinel
    around it is untouched. -> [check, ...]."""
    import torch
    rows = []
    for shape in (PROBE_SHAPE, RAGGED_COPY_SHAPE):
        g = torch.Generator(device=DEVICE).manual_seed(7)
        x4 = torch.rand(shape, generator=g, device=DEVICE).to(torch.bfloat16)
        buf = torch.empty(x4.numel() + 2 * COPY_GUARD, dtype=x4.dtype,
                          device=DEVICE)
        for name, kind, tiles in COPY_KERNELS:
            x = probe.view(x4, kind)
            fn = getattr(kcopy, name)
            for tile in tiles:
                buf.fill_(COPY_SENTINEL)
                out = buf[COPY_GUARD:COPY_GUARD + x.numel()].view(x.shape)
                fn(x, tile, out=out)
                torch.cuda.synchronize()
                same = torch.equal(out.view(torch.int16), x.view(torch.int16))
                guard = bool((buf[:COPY_GUARD] == COPY_SENTINEL).all()) and \
                    bool((buf[COPY_GUARD + x.numel():] ==
                          COPY_SENTINEL).all())
                rows.append({"name": name, "shape": list(x.shape),
                             "tile": tile,
                             **copy_layout(kcopy, kind, x, tile),
                             "max_abs_err": float((out.float() - x.float())
                                                  .abs().max()),
                             "ok": same and guard, "bitwise": same,
                             "guard": guard})
        del x4, buf
    return rows


def copy_layout(kcopy, kind, x, tile):
    """How a copy kernel cuts its view x at `tile`: -> {design, grid,
    chunk_bytes, chunks}."""
    m = kcopy.chunk_map(kind, x.shape, tile, x.element_size())
    return {"design": "bulk_ring", "grid": kcopy.ring_grid(),
            "chunk_bytes": m.chunk_bytes, "chunks": m.chunks}


def time_copies(kcopy, probe):
    """Each copy kernel at both of its tiles of the sweep, at the probe's
    shape, beside its plain version and x.clone(): -> {name: timings}, the
    first tile's numbers at the top and every tile's under "by_tile"."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(8)
    x4 = torch.rand(PROBE_SHAPE, generator=g, device=DEVICE).to(
        torch.bfloat16)
    nbytes = 2 * x4.numel() * x4.element_size()          # read + write
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for name, kind, tiles in COPY_KERNELS:
        x = probe.view(x4, kind)
        fn = getattr(kcopy, name)
        dst = torch.empty_like(x)
        clone_ms = time_ms(lambda: x.clone(), iters=COPY_ITERS)
        by_tile = []
        for tile in tiles:
            ms = time_ms(lambda: fn(x, tile, out=dst), iters=COPY_ITERS)
            by_tile.append({"tile": tile, "ms": ms,
                            "gb_per_s": nbytes / ms / 1e6,
                            "of_clone": clone_ms / ms,
                            **copy_layout(kcopy, kind, x, tile)})
        out[name] = {
            **by_tile[0], "by_tile": by_tile,
            "plain_ms": time_ms(lambda: kcopy.copy_plain(x, dst),
                                iters=COPY_ITERS),
            "library_ms": clone_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}
    return out


def layout_text(r) -> str:
    return (f"{r['design']}, grid {r['grid']}, {r['chunks']} chunks of "
            f"{r['chunk_bytes']} B")


def ptxas_text(usage: dict, ring_bytes: int) -> str:
    """One line of ptxas' report: registers, static shared memory and
    spills of each kernel."""
    parts = []
    for name, u in sorted(usage.items()):
        extra = (f" + {ring_bytes} B dynamic ring"
                 if "ring_copy_kernel" in name else "")
        parts.append(f"{name} {u['registers']} regs {u['smem_bytes']} B "
                     f"smem{extra} {u['spill_bytes']} B spill")
    return "; ".join(parts)


def run_probe(kcopy, probe):
    """The probe's sweep through its entry point, with the copy kernels'
    counts set to 0 just before and read just after."""
    kcopy.reset_launches()
    rows = probe.main(["--device", DEVICE])
    counts = kcopy.launches()
    need(len(rows) == len(probe.SWEEP) and
         all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows),
         "the probe's sweep did not time every line")
    for name, count in counts.items():
        need(count > 0, f"{name} was not launched by the probe's sweep")
    return rows, counts


# ---------------------------------------------------------------------------
# phases 9-11: TTA, on-device metrics and ensembles
# ---------------------------------------------------------------------------

def padded(a, hw):
    """A 2-D uint8 image -> float32 (H, W) zero-padded to the batch shape
    hw, and its mask."""
    import numpy as np
    h, w = a.shape
    img = np.zeros(hw, np.float32)
    img[:h, :w] = a
    m = np.zeros(hw, np.float32)
    m[:h, :w] = 1.0
    return img, m


def check_device_metrics(summary, data: str, out: str):
    """The card's per-image RMSE and SSIM against (a) the host metrics on
    the PNGs the eval wrote and (b) the same tensor metrics run on the CPU
    on those bytes, padded and masked as the batch was. -> largest gaps."""
    import torch
    from codon_tpu_torch.data.io import imread_gray
    from codon_tpu_torch.metrics.rmse import masked_rmse, masked_rmse_torch
    from codon_tpu_torch.metrics.ssim import ssim_exact, ssim_exact_torch
    gaps = {"rmse_host": 0.0, "ssim_host": 0.0, "rmse_cpu": 0.0,
            "ssim_cpu": 0.0}
    for row in summary["per_image"]:
        img = imread_gray(os.path.join(out, row["name"] + ".png"))
        lab = imread_gray(os.path.join(data, "input_label",
                                       row["name"] + ".png"))
        gaps["rmse_host"] = max(gaps["rmse_host"],
                                abs(row["rmse"] - masked_rmse(lab, img)))
        gaps["ssim_host"] = max(gaps["ssim_host"], abs(
            row["ssim"] - ssim_exact(lab / 255, img / 255)))
        o, m = padded(img, MAIN_SHAPE[1:3])
        lb, _ = padded(lab, MAIN_SHAPE[1:3])
        o, m, lb = (torch.from_numpy(t)[None] for t in (o, m, lb))
        gaps["rmse_cpu"] = max(gaps["rmse_cpu"], abs(
            row["rmse"] - float(masked_rmse_torch(lb, o, m)[0])))
        gaps["ssim_cpu"] = max(gaps["ssim_cpu"], abs(
            row["ssim"] - float(ssim_exact_torch(lb / 255.0, o / 255.0,
                                                 mask=m)[0])))
    need(gaps["rmse_host"] < RMSE_HOST_TOL,
         f"card RMSE vs host RMSE on the PNGs: {gaps['rmse_host']}")
    need(gaps["ssim_host"] < SSIM_HOST_TOL,
         f"card SSIM vs host SSIM on the PNGs: {gaps['ssim_host']}")
    need(gaps["rmse_cpu"] <= METRIC_CPU_TOL and
         gaps["ssim_cpu"] <= METRIC_CPU_TOL,
         f"card metrics vs the same metrics on the CPU: {gaps}")
    return gaps


def run_tta_path(kc, data: str, tmp: str):
    """cli eval --tta8 --device-metrics, bf16, batch 4, with the CAC
    counts set to 0 just before and read just after; then the same eval
    warm, and warm with host metrics, for their rates."""
    batch = 4
    n_images = len(SCENES)
    out = os.path.join(tmp, "tta8_dm")
    kc.reset_launches()
    summary, wall = eval_once(data, out, os.path.join(tmp, "tta8_dm.json"),
                              batch, ["--tta8", "--device-metrics"])
    counts = kc.launches()
    need(summary["tta_transforms"] == 8, "the eval did not run TTA8")
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the TTA8 eval did not score every image")
    batches = -(-n_images // batch)
    for name, count in counts.items():
        need(count == 2 * 5 * batches,
             f"{name} launched {count} times in {batches} TTA8 batches; "
             f"expected {2 * 5 * batches} (2 forwards x 5 CAC stages)")
    gaps = check_device_metrics(summary, data, out)
    warm_dm, _ = eval_once(data, os.path.join(tmp, "tta8_dm2"),
                           os.path.join(tmp, "tta8_dm2.json"), batch,
                           ["--tta8", "--device-metrics"])
    warm_host, _ = eval_once(data, os.path.join(tmp, "tta8_host"),
                             os.path.join(tmp, "tta8_host.json"), batch,
                             ["--tta8"])
    need(all(r["rmse"] == w["rmse"] for r, w in
             zip(summary["per_image"], warm_dm["per_image"])),
         "the warm TTA8 eval scored differently")
    return summary, wall, counts, gaps, warm_dm, warm_host


def first_batch(data: str):
    from codon_tpu_torch.data.io import discover_pairs, load_sample
    from codon_tpu_torch.data.pipeline import make_batch
    names = discover_pairs(data)[:4]
    return make_batch([load_sample(data, n) for n in names], 32, DEVICE,
                      fixed_hw=MAIN_SHAPE[1:3])


def compare_tta_paths(data: str):
    """fp32 TTA8 on the first batch, through the kernels and through the
    plain stage -> max abs diff."""
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.codon_net import CodonConfig, codon_forward
    from codon_tpu_torch.models.tta import make_tta_forward
    params = params_from_numpy(load_npz(CKPT), DEVICE)
    b = first_batch(data)
    outs = []
    for impl in ("kernel", "torch"):
        cfg = CodonConfig(dead_heads=True, cac_impl=impl)
        tta = make_tta_forward(
            lambda p, d, c, m, cfg=cfg: codon_forward(p, d, c, mask=m,
                                                      cfg=cfg),
            transforms=8)
        outs.append(tta(params, b.depth, b.color, b.mask))
    need(bool(torch.isfinite(outs[0]).all()), "non-finite fp32 TTA8")
    diff = float((outs[0] - outs[1]).abs().max())
    need(diff <= FWD_TOL, f"fp32 TTA8, kernels vs plain stage: max abs diff "
         f"{diff} > {FWD_TOL}")
    return diff


def run_ensemble(kc, data: str, tmp: str):
    """A 2-member ensemble with --tta: (a) in fp32 on the first batch,
    through the cli's own forward, against the mean of the two members'
    TTA forwards; (b) `cli eval` in bf16, with the CAC counts set to 0 just
    before and read just after."""
    import torch
    from codon_tpu_torch import cli
    b = first_batch(data)

    def forward(ckpt):
        args = cli._build_argparser().parse_args(
            ["eval", "--ckpt", ckpt, "--tta", "--dtype", "fp32",
             "--device", DEVICE])
        ef = cli.make_eval_forward(args, torch.device(DEVICE))
        return ef, ef.fwd(ef.params, b.depth, b.color, b.mask)

    ef, ens = forward(f"{CKPT},{CKPT2}")
    need(ef.ensemble and ef.tta == 4, "the cli did not build a TTA ensemble")
    solo = [forward(c)[1] for c in (CKPT, CKPT2)]
    diff = float((ens - (solo[0] + solo[1]) / 2).abs().max())
    need(diff <= FWD_TOL, f"fp32 ensemble vs the mean of its members: max "
         f"abs diff {diff} > {FWD_TOL}")
    spread = float((solo[0] - solo[1]).abs().max())
    need(spread > 10 * FWD_TOL, f"the two members agree to {spread}: "
         f"the check could not tell them apart")

    kc.reset_launches()
    summary, wall = eval_once(data, os.path.join(tmp, "ens"),
                              os.path.join(tmp, "ens.json"), 4, ["--tta"],
                              ckpt=f"{CKPT},{CKPT2}")
    counts = kc.launches()
    batches = -(-len(SCENES) // 4)
    for name, count in counts.items():
        need(count == 2 * 5 * batches,
             f"{name} launched {count} times in the ensemble eval; expected "
             f"{2 * 5 * batches} (2 members x 5 CAC stages a batch)")
    need(all(math.isfinite(summary[k]) for k in ("mean_rmse", "mean_ssim")),
         "the ensemble eval's means are not finite")
    return diff, spread, summary, wall, counts


# ---------------------------------------------------------------------------
# phases 12-17: the static-int8 family
# ---------------------------------------------------------------------------

def quant_inputs(shape, valid, seed):
    """Activations (float32, x3 so the static grid clips some), their
    scales, a mask as the stage checks place it, and int32 products."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=DEVICE) * 3
    sc = torch.rand((c,), generator=g, device=DEVICE) * 0.05 + 0.005
    sx = torch.rand((n,), generator=g, device=DEVICE) * 0.05 + 0.005
    mask = make_mask(shape, valid)
    acc = torch.randint(-2 ** 20, 2 ** 20, (n * h * w, c), generator=g,
                        device=DEVICE, dtype=torch.int32)
    acc[::7] *= 2 ** 9          # sums past 2^24, where int32 -> f32 rounds
    sw = torch.rand((c,), generator=g, device=DEVICE) * 1e-3
    return x, sc, sx, mask, acc, sw


def check_quant_kernels(kq):
    """quant_im2col in float32, bfloat16 and int8 input, each scale mode,
    k 1, 3 and 5; dequant_epilogue in float32, bfloat16 and float16,
    static and dynamic, with and without the mask; at the main, odd and
    both TTA8 shapes; bitwise. -> {name: [check, ...]}."""
    import torch
    checks = {"quant_im2col": [], "dequant_epilogue": []}
    for i, (shape, valid) in enumerate(STAGE_CASES):
        x, sc, sx, mask, acc, sw = quant_inputs(shape, valid, 200 + i)
        for dname in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dname)
            xd = (kq.quantize_plain(x, sc) if dtype == torch.int8
                  else x.to(dtype).contiguous())
            modes = ([("none", None, None)] if dtype == torch.int8 else
                     [("channel", sc, None), ("sample", None, sx)])
            for mode, a, b in modes:
                for k in (1, 3, 5):
                    got = kq.quant_im2col(xd, k, a, b)
                    want = kq.quant_im2col_plain(xd, k, a, b)
                    same = torch.equal(got, want)
                    err = float((got.float() - want.float()).abs().max())
                    checks["quant_im2col"].append(
                        {"dtype": dname, "shape": list(shape), "k": k,
                         "mode": mode, "max_abs_err": err, "bitwise": same,
                         "ok": same})
                    del got, want
            del xd
        n, h, w, _ = shape
        for dname in ("float32", "bfloat16", "float16"):
            dtype = getattr(torch, dname)
            # float16 holds at most 65504: sums that stay below it
            a = (acc if dtype != torch.float16 else
                 torch.div(acc, 2 ** 14, rounding_mode="floor"))
            for mode, b in (("static", None), ("dynamic", sx)):
                for m in (mask.to(dtype), None):
                    got = kq.dequant_epilogue(a, sw, dtype, (n, h, w), b, m)
                    want = kq.dequant_epilogue_plain(a, sw, dtype,
                                                     (n, h, w), b, m)
                    same = torch.equal(got, want)
                    checks["dequant_epilogue"].append(
                        {"dtype": dname, "shape": list(shape), "mode": mode,
                         "mask": m is not None, "bitwise": same,
                         "max_abs_err": float((got.float() - want.float())
                                              .abs().max()),
                         "ok": same})
        del x, acc
        torch.cuda.empty_cache()
    return checks


def int8_launches(kq, n, h, w):
    """dequant_epilogue and GEMM launches of one int8 forward of n images
    at h x w: one a block of images at each quantized conv call. Each is
    also a quant_im2col launch; the static backend's handoffs add
    INT8_HANDOFFS more."""
    return sum(calls * len(kq.image_blocks(n, h, w, k * k * c))
               for k, c, calls in INT8_CONVS)


def time_quant(kq):
    """bf16 at the shapes of the int8 forward at batch 4, 384 x 480: each
    quant kernel's wrapper over back-to-back calls, its plain version, its
    device time a launch from a CUDA graph, and its byte bound, at each
    distinct shape of the main path; the int8 GEMM (torch._int_mm) over
    back-to-back calls at each. -> ({name: timings}, [gemm rows])."""
    import torch
    n, h, w = MAIN_SHAPE[:3]
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(300)
    mask = make_mask(MAIN_SHAPE, MAIN_VALID).to(bf)
    # (k, C_in, C_out, calls a forward, input): the quantized convs of one
    # forward grouped by shape; "int8" input is a precommitted packed site
    # the handoffs' quantize, k = 1 on 64 channels, has no GEMM (C_out 0)
    sites = ((3, 64, 64, 3, "bf16"), (5, 64, 128, 13, "int8"),
             (5, 128, 128, 13, "bf16"), (1, 128, 64, 13, "bf16"),
             (3, 128, 64, 1, "bf16"), (1, 64, 0, INT8_HANDOFFS, "bf16"))
    out = {"quant_im2col": {"by_shape": []},
           "dequant_epilogue": {"by_shape": []}}
    gemms = []
    for k, ci, co, calls, kind in sites:
        kk = k * k * ci
        blocks = kq.image_blocks(n, h, w, kk)
        nb = blocks[0][1] - blocks[0][0]
        x = torch.randn((nb, h, w, ci), generator=g, device=DEVICE) * 3
        sc = torch.rand((ci,), generator=g, device=DEVICE) * 0.05 + 0.005
        if kind == "int8":
            xin, a = kq.quantize_plain(x, sc), None
        else:
            xin, a = x.to(bf).contiguous(), sc
        rows = nb * h * w
        im_bytes = xin.numel() * xin.element_size() + rows * kk
        im_bound = bound(im_bytes, 0 if a is None else xin.numel())
        r = {"shape": [nb, h, w, ci], "k": k, "input": kind,
             "calls_a_forward": calls * len(blocks),
             "device_ms": graph_ms(lambda: kq.quant_im2col(xin, k, a)),
             "bound_ms": im_bound[0], "bound_by": im_bound[1]}
        out["quant_im2col"]["by_shape"].append(r)
        if not co:
            continue
        patches = kq.quant_im2col(xin, k, a)
        # column-major (K, N): cuBLASLt's int8 GEMM takes B so
        w8 = torch.randint(-127, 128, (co, kk), generator=g, device=DEVICE,
                           dtype=torch.int8).t()
        gemm_ms = time_ms(lambda: torch._int_mm(patches, w8))
        gb_bytes = rows * kk + kk * co + rows * co * 4
        gb = max(gb_bytes / HBM_BYTES_PER_S, 2 * rows * kk * co
                 / INT8_OPS_PER_S) * 1e3
        gemms.append({"m": rows, "k": kk, "n": co,
                      "calls_a_forward": calls * len(blocks),
                      "ms": gemm_ms, "bound_ms": gb,
                      "bound_by": ("bytes" if gb_bytes / HBM_BYTES_PER_S >=
                                   2 * rows * kk * co / INT8_OPS_PER_S
                                   else "operations")})
        acc = torch._int_mm(patches, w8)
        del patches
        sw = torch.rand((co,), generator=g, device=DEVICE) * 1e-3
        m = mask[:nb].contiguous()
        ep_bytes = rows * co * 4 + rows * 2 + rows * co * 2
        ep_bound = bound(ep_bytes, 3 * rows * co)
        e = {"shape": [nb, h, w, co], "calls_a_forward": calls * len(blocks),
             "device_ms": graph_ms(lambda: kq.dequant_epilogue(
                 acc, sw, bf, (nb, h, w), None, m)),
             "bound_ms": ep_bound[0], "bound_by": ep_bound[1]}
        out["dequant_epilogue"]["by_shape"].append(e)
        if (k, ci) == (5, 128):
            # the heaviest site (conv3, conv6, conv10): the row of record
            out["quant_im2col"].update(
                device_ms=r["device_ms"],
                ms=time_ms(lambda: kq.quant_im2col(xin, k, a)),
                plain_ms=time_ms(lambda: kq.quant_im2col_plain(xin, k, a),
                                 warmup=1, iters=5),
                bound_ms=im_bound[0], bound_by=im_bound[1],
                shape=[nb, h, w, ci], k=k)
            out["dequant_epilogue"].update(
                device_ms=e["device_ms"],
                ms=time_ms(lambda: kq.dequant_epilogue(acc, sw, bf,
                                                       (nb, h, w), None, m)),
                plain_ms=time_ms(lambda: kq.dequant_epilogue_plain(
                    acc, sw, bf, (nb, h, w), None, m)),
                bound_ms=ep_bound[0], bound_by=ep_bound[1],
                shape=[nb, h, w, co])
        del x, xin, acc
        torch.cuda.empty_cache()
    for name in out:
        rows = out[name]["by_shape"]
        # summed over the forward's calls: device ms a b4 forward
        out[name]["device_ms_a_forward"] = sum(
            r["device_ms"] * r["calls_a_forward"] for r in rows)
        out[name]["bound_ms_a_forward"] = sum(
            r["bound_ms"] * r["calls_a_forward"] for r in rows)
    return out, gemms


def static_int8_ops(dtype, impl=None):
    """Int8StaticOps on x4_ship4_qat_static's scales, on the card."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.quant_ops import Int8StaticOps
    scales = params_from_numpy(load_npz(CKPT_INT8)["act_scales"], DEVICE)
    return Int8StaticOps(scales, compute_dtype=dtype, quant_impl=impl)


def compare_int8_paths(data: str):
    """fp32 int8 forward of the first batch (x4_ship4_qat_static), the
    quant kernels against their plain versions, the CAC kernels in both,
    under cuDNN's deterministic mode: bitwise. Then card against CPU at 37
    x 29 in the flip class. -> (max |d| kernels vs plain, (mean, max) card
    vs CPU)."""
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.codon_net import CodonConfig, codon_forward
    tree = load_npz(CKPT_INT8)
    tree.pop("act_scales")
    params = params_from_numpy(tree, DEVICE)
    b = first_batch(data)
    cfg = CodonConfig(dead_heads=True, cac_impl="kernel")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = [codon_forward(params, b.depth, b.color, mask=b.mask, cfg=cfg,
                              ops=static_int8_ops(torch.float32, impl))
                for impl in (None, "plain")]
    finally:
        torch.backends.cudnn.deterministic = saved
    need(bool(torch.isfinite(outs[0]).all()), "non-finite fp32 int8 forward")
    d_paths = float((outs[0] - outs[1]).abs().max())
    need(torch.equal(outs[0], outs[1]), f"fp32 int8 forward, quant kernels "
         f"vs plain: max abs diff {d_paths}, not bitwise")

    from codon_tpu_torch.quant_ops import Int8StaticOps
    g = torch.Generator().manual_seed(2)
    d = torch.rand((1, 37, 29, 1), generator=g)
    c = torch.rand((1, 37, 29, 1), generator=g)
    cfg = CodonConfig(dead_heads=True)
    on_card = codon_forward(params, d.to(DEVICE), c.to(DEVICE), cfg=cfg,
                            ops=static_int8_ops(torch.float32)).cpu()
    cpu_scales = load_npz(CKPT_INT8)["act_scales"]
    on_cpu = codon_forward(params_from_numpy(tree, "cpu"), d, c, cfg=cfg,
                           ops=Int8StaticOps(cpu_scales))
    diff = (on_card - on_cpu).abs()
    d_cpu = (float(diff.mean()), float(diff.max()))
    need(d_cpu[0] <= INT8_CPU_BOUNDS[0] and d_cpu[1] <= INT8_CPU_BOUNDS[1],
         f"fp32 int8 forward, card vs CPU: mean {d_cpu[0]} max {d_cpu[1]}, "
         f"outside the flip class {INT8_CPU_BOUNDS}")
    return d_paths, d_cpu


def read_counts(kc, kq):
    return {**kc.launches(), **kq.launches()}


def reset_counts(kc, kq):
    kc.reset_launches()
    kq.reset_launches()


def need_int8_counts(counts, cac_want, conv_want, handoffs, what):
    """The CAC kernels cac_want launches each; the epilogue and the GEMM
    one a conv block, conv_want; quant_im2col those and the handoffs'."""
    want = {"cac_stats": cac_want, "spatial_logits": cac_want,
            "cac_apply": cac_want, "dequant_epilogue": conv_want,
            "int8_gemm": conv_want, "quant_im2col": conv_want + handoffs}
    for name, n in want.items():
        need(counts[name] == n, f"{what}: {name} launched {counts[name]} "
             f"times; expected {n}")


def run_int8_path(kc, kq, data: str, tmp: str):
    """cli eval --dtype int8 (x4_ship4_qat_static, bf16, batch 4), with
    the CAC and quant counts set to 0 just before and read just after;
    then the same eval warm."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    reset_counts(kc, kq)
    summary, wall = eval_once(data, os.path.join(tmp, "int8"),
                              os.path.join(tmp, "int8.json"), 4,
                              ckpt=CKPT_INT8, dtype="int8")
    counts = read_counts(kc, kq)
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the int8 eval did not score every image")
    need(len(os.listdir(os.path.join(tmp, "int8"))) == n_images,
         "the int8 eval did not write every PNG")
    need_int8_counts(counts, 5 * batches,
                     batches * int8_launches(kq, *MAIN_SHAPE[:3]),
                     batches * INT8_HANDOFFS, "int8 eval")
    warm, _ = eval_once(data, os.path.join(tmp, "int8_warm"),
                        os.path.join(tmp, "int8_warm.json"), 4,
                        ckpt=CKPT_INT8, dtype="int8")
    need(all(warm[k] == summary[k] for k in ("mean_rmse", "mean_ssim")),
         "the warm int8 eval scored differently")
    return summary, wall, counts, warm


def run_int8_tta_path(kc, kq, data: str, tmp: str):
    """cli eval --dtype int8 --tta8 --device-metrics, with the counts set
    to 0 just before and read just after; metrics held as the bf16 TTA8
    phase holds them."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    out = os.path.join(tmp, "int8_tta8")
    reset_counts(kc, kq)
    summary, wall = eval_once(data, out, os.path.join(tmp, "int8_tta8.json"),
                              4, ["--tta8", "--device-metrics"],
                              ckpt=CKPT_INT8, dtype="int8")
    counts = read_counts(kc, kq)
    need(summary["tta_transforms"] == 8, "the int8 eval did not run TTA8")
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the int8 TTA8 eval did not score every image")
    n, h, w = TTA_SHAPE[:3]
    need_int8_counts(counts, 2 * 5 * batches,
                     batches * (int8_launches(kq, n, h, w) +
                                int8_launches(kq, n, w, h)),
                     2 * batches * INT8_HANDOFFS, "int8 TTA8 eval")
    gaps = check_device_metrics(summary, data, out)
    return summary, wall, counts, gaps


def run_int8_ensemble(kc, kq, data: str, tmp: str):
    """A static + dynamic int8 ensemble with --tta: its forward through
    the cli against the mean of its members' (cuDNN deterministic), then
    `cli eval` with the counts set to 0 just before and read just after."""
    import torch
    from codon_tpu_torch import cli
    b = first_batch(data)

    def forward(ckpt):
        args = cli._build_argparser().parse_args(
            ["eval", "--ckpt", ckpt, "--tta", "--dtype", "int8",
             "--device", DEVICE])
        ef = cli.make_eval_forward(args, torch.device(DEVICE))
        return ef, ef.fwd(ef.params, b.depth, b.color, b.mask)

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ef, ens = forward(f"{CKPT_INT8},{CKPT_INT8_DYN}")
        solo = [forward(c)[1] for c in (CKPT_INT8, CKPT_INT8_DYN)]
    finally:
        torch.backends.cudnn.deterministic = saved
    need(ef.ensemble and ef.tta == 4, "the cli did not build a TTA ensemble")
    diff = float((ens - (solo[0] + solo[1]) / 2).abs().max())
    need(diff <= FWD_TOL, f"int8 ensemble vs the mean of its members: max "
         f"abs diff {diff} > {FWD_TOL}")
    spread = float((solo[0] - solo[1]).abs().max())
    need(spread > 10 * FWD_TOL, f"the static and dynamic members agree to "
         f"{spread}: the check could not tell them apart")

    reset_counts(kc, kq)
    summary, wall = eval_once(data, os.path.join(tmp, "int8_ens"),
                              os.path.join(tmp, "int8_ens.json"), 4,
                              ["--tta"], ckpt=f"{CKPT_INT8},{CKPT_INT8_DYN}",
                              dtype="int8")
    counts = read_counts(kc, kq)
    batches = -(-len(SCENES) // 4)
    # the static member hands off through quant_im2col, the dynamic one
    # has no handoffs
    need_int8_counts(counts, 2 * 5 * batches,
                     2 * batches * int8_launches(kq, *TTA_SHAPE[:3]),
                     batches * INT8_HANDOFFS, "int8 ensemble eval")
    need(all(math.isfinite(summary[k]) for k in ("mean_rmse", "mean_ssim")),
         "the int8 ensemble eval's means are not finite")
    return diff, spread, summary, wall, counts

# ---------------------------------------------------------------------------
# phases 16-17: the reference's .pth checkpoints
# ---------------------------------------------------------------------------

def refnet(state_dict):
    """A stand-in for the reference's pickled model: a module tree whose
    state dict carries `state_dict`'s names and values, and no forward.
    The class is made at first use (torch is imported lazily) and bound
    to this module's name, so that a pickle of it loads again here."""
    import torch
    cls = globals().get("RefNet")
    if cls is None:
        class RefNet(torch.nn.Module):
            def __init__(self, sd):
                super().__init__()
                for key, value in sd.items():
                    *path, leaf = key.split(".")
                    mod = self
                    for part in path:
                        if part not in mod._modules:
                            mod.add_module(part, torch.nn.Module())
                        mod = mod._modules[part]
                    mod.register_parameter(leaf, torch.nn.Parameter(
                        value, requires_grad=False))
        RefNet.__qualname__ = "RefNet"
        globals()["RefNet"] = cls = RefNet
    return cls(state_dict)


def write_pth_files(tmp: str):
    """x4_ship4.npz under the reference's names, three ways: a plain state
    dict, {"epoch", "model": <state dict with DataParallel's module.
    prefix>}, and a pickled stand-in module. -> {kind: path}."""
    import numpy as np
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz
    from codon_tpu_torch.checkpoint.torch_convert import (
        params_to_torch_state_dict)
    from codon_tpu_torch.models.codon_net import CodonConfig
    cfg = CodonConfig(dead_heads=True)
    tree = load_npz(CKPT)

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}

    sd = tensors(params_to_torch_state_dict(tree, cfg))
    paths = {k: os.path.join(tmp, f"x4_ship4_{k}.pth")
             for k in PTH_KINDS}
    torch.save(sd, paths["state_dict"])
    torch.save({"epoch": 40, "model": tensors(params_to_torch_state_dict(
        tree, cfg, module_prefix=True))}, paths["epoch_model_module_prefix"])
    torch.save(refnet(sd), paths["full_module"])
    return paths


def same_trees(a, b) -> bool:
    import numpy as np
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(same_trees(a[k], b[k]) for k in a))
    return a.dtype == b.dtype and np.array_equal(a, b)


def run_pth_path(kc, data: str, tmp: str):
    """`cli eval --ckpt` on each .pth (bf16, batch 4, the CAC counts set to
    0 just before and read just after each) against `--ckpt x4_ship4.npz`:
    the same PNGs and metrics, bit for bit (cuDNN deterministic in all
    four); then `cli convert` of each back to the checkpoint's arrays.
    -> {kind: (summary, wall, counts)}."""
    import numpy as np
    import torch
    from codon_tpu_torch import cli
    from codon_tpu_torch.checkpoint.native import load_npz
    from codon_tpu_torch.data.io import imread_gray
    paths = write_pth_files(tmp)
    batches = -(-len(SCENES) // 4)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        ref_out = os.path.join(tmp, "pth_ref")
        ref, _ = eval_once(data, ref_out, os.path.join(tmp, "pth_ref.json"),
                           4)
        for kind, path in paths.items():
            out = os.path.join(tmp, f"pth_{kind}")
            kc.reset_launches()
            summary, wall = eval_once(data, out, out + ".json", 4,
                                      ckpt=path)
            counts = kc.launches()
            need(summary["per_image"] == ref["per_image"],
                 f".pth eval ({kind}) scored differently from the .npz "
                 f"eval")
            for row in ref["per_image"]:
                a, b = (imread_gray(os.path.join(d, row["name"] + ".png"))
                        for d in (out, ref_out))
                need(np.array_equal(a, b), f".pth eval ({kind}) wrote "
                     f"another {row['name']}.png than the .npz eval")
            for name, count in counts.items():
                need(count == 5 * batches, f".pth eval ({kind}): {name} "
                     f"launched {count} times; expected {5 * batches}")
            npz = os.path.join(tmp, f"converted_{kind}.npz")
            need(cli.main(["convert", "--pth", path, "--npz", npz]) == 0,
                 f"cli convert of the {kind} .pth failed")
            need(same_trees(load_npz(npz), load_npz(CKPT)),
                 f"cli convert of the {kind} .pth gave other arrays than "
                 f"x4_ship4.npz")
            runs[kind] = (summary, wall, counts)
    finally:
        torch.backends.cudnn.deterministic = saved
    return runs


# ---------------------------------------------------------------------------
# phases 18-20: the merged-tower forward (codon_fused), float and int8
# ---------------------------------------------------------------------------

def make_merged_inputs(shape, valid, dtype, seed):
    """T and inputs2, (N, H, W, 2C) zero on padding, whose halves are the
    towers, as the merged-tower forward hands them to the CAC kernels; and
    the rest of a stage's inputs. valid as in `make_mask`."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mask = make_mask(shape, valid)
    T, inputs2 = [(torch.randn((n, h, w, 2 * c), generator=g, device=DEVICE)
                   * mask).to(dtype).contiguous() for _ in range(2)]
    gate = torch.rand((n, 1, c), generator=g, device=DEVICE)
    logits = torch.randn((n, h, w), generator=g, device=DEVICE).to(dtype)
    return T, inputs2, mask.to(dtype), gate, logits


def check_pitched_kernels(kc):
    """cac_stats and cac_apply on the halves of T (a tower pitch of 2C),
    cac_apply writing both halves of the next T, against their plain
    versions on the same views, at the fused eval's shape and both TTA8
    shapes, every dtype, the contiguous checks' tolerances. ->
    {name: [check, ...]}."""
    import torch
    checks = {"cac_stats": [], "cac_apply": []}
    seed = 500
    for dname, (atol, rtol) in TOLS.items():
        dtype = getattr(torch, dname)
        for shape, valid in (STAGE_CASES[0],) + STAGE_CASES[2:]:
            seed += 1
            c = shape[-1]
            T, inputs2, mask, gate, logits = make_merged_inputs(
                shape, valid, dtype, seed)
            halves = (T[..., :c], T[..., c:], inputs2[..., :c],
                      inputs2[..., c:])
            npix = shape[1] * shape[2]
            for m in (mask, None):
                got = kc.cac_stats(halves[0], halves[1], m)
                want = kc.cac_stats_plain(halves[0], halves[1], m)
                err_f32, ok_f32 = max_err(
                    (got[0] / npix, got[1]), (want[0] / npix, want[1]),
                    *TOLS["float32"])
                err, ok = max_err(got[2:], want[2:], atol, rtol)
                checks["cac_stats"].append(
                    {"dtype": dname, "shape": list(shape), "pitch": 2 * c,
                     "mask": m is not None, "max_abs_err": max(err, err_f32),
                     "ok": ok and ok_f32})
            nxt = torch.full_like(T, float("nan"))
            want_t = torch.full_like(T, float("nan"))
            kc.cac_apply(*halves, gate, logits,
                         dst=(nxt[..., :c], nxt[..., c:]))
            kc.cac_apply_plain(*halves, gate, logits,
                               dst=(want_t[..., :c], want_t[..., c:]))
            err, ok = max_err([nxt], [want_t], atol, rtol)
            checks["cac_apply"].append(
                {"dtype": dname, "shape": list(shape), "pitch": 2 * c,
                 "max_abs_err": err,
                 "ok": ok and not bool(torch.isnan(nxt).any())})
            del T, inputs2, nxt, want_t
        torch.cuda.empty_cache()
    return checks


def check_stats_repeats(kc):
    """cac_stats' determinism and its one launch a call, bf16 with the
    mask, at the main, odd and training shapes: two eager calls give the
    same bits, and a CUDA graph of one call, replayed twice, gives the
    eager calls' bits after each replay (every launch leaves the kernel's
    arrival counters at zero). -> [check, ...]."""
    import torch
    rows = []
    for i, (shape, valid) in enumerate((STAGE_CASES[0], STAGE_CASES[1],
                                        STAGE_CASES[4])):
        (out, out_c, _, _), mask, *_ = make_stage_inputs(
            shape, valid, torch.bfloat16, 700 + i)
        n0 = kc.cac_stats.launches
        first = kc.cac_stats(out, out_c, mask)
        again = kc.cac_stats(out, out_c, mask)
        launches = kc.cac_stats.launches - n0
        eager = all(torch.equal(a, b) for a, b in zip(first, again))
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = kc.cac_stats(out, out_c, mask)
        graph = True
        for _ in range(2):
            g.replay()
            torch.cuda.synchronize()
            graph = graph and all(torch.equal(a, b)
                                  for a, b in zip(captured, first))
        rows.append({"shape": list(shape), "eager": eager, "graph": graph,
                     "launches_2_calls": launches,
                     "ok": eager and graph and launches == 2})
        del g, captured, out, out_c, mask
    torch.cuda.empty_cache()
    return rows


def time_pitched_kernels(kc, timings):
    """bf16 device time a launch (a CUDA graph of back-to-back calls) of
    cac_stats and cac_apply on the halves of T, at the main and both TTA8
    shapes, beside the contiguous kernels' at the same shape and in the
    same run (`timings`, from `time_kernels`). The bound is the
    contiguous one: the same bytes move. -> {name: [row, ...]}."""
    import torch
    rows = {"cac_stats": [], "cac_apply": []}
    for i, (shape, valid) in enumerate((STAGE_CASES[0],) + STAGE_CASES[2:]):
        c = shape[-1]
        T, inputs2, mask, gate, logits = make_merged_inputs(
            shape, valid, torch.bfloat16, 600 + i)
        halves = (T[..., :c], T[..., c:], inputs2[..., :c], inputs2[..., c:])
        nxt = torch.empty_like(T)
        calls = {
            "cac_stats": lambda: kc.cac_stats(halves[0], halves[1], mask),
            "cac_apply": lambda: kc.cac_apply(
                *halves, gate, logits, dst=(nxt[..., :c], nxt[..., c:]))}
        for name, fn in calls.items():
            flat = timings[name]["by_shape"][i]
            need(flat["shape"] == list(shape), "shape order of time_kernels")
            rows[name].append({
                "shape": list(shape), "pitch": 2 * c,
                "device_ms": graph_ms(fn),
                "contiguous_device_ms": flat["device_ms"],
                "bound_ms": flat["bound_ms"], "bound_by": flat["bound_by"]})
        del T, inputs2, nxt
        torch.cuda.empty_cache()
    return rows


def run_fused_path(kc, data: str, tmp: str):
    """`cli eval --variant codon_fused` (bf16, batch 4), then with --tta8
    --device-metrics, each with the CAC counts set to 0 just before and
    read just after: 5 launches of each kernel a forward; the TTA8 eval's
    metrics held as the packed TTA8 eval's."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    kc.reset_launches()
    summary, wall = eval_once(data, os.path.join(tmp, "fused"),
                              os.path.join(tmp, "fused.json"), 4,
                              variant="codon_fused")
    counts = kc.launches()
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the codon_fused eval did not score every image")
    need(len(os.listdir(os.path.join(tmp, "fused"))) == n_images,
         "the codon_fused eval did not write every PNG")
    for name, count in counts.items():
        need(count == 5 * batches, f"codon_fused eval: {name} launched "
             f"{count} times; expected {5 * batches} (5 CAC stages a "
             f"forward)")
    out = os.path.join(tmp, "fused_tta8")
    kc.reset_launches()
    tta, tta_wall = eval_once(data, out, out + ".json", 4,
                              ["--tta8", "--device-metrics"],
                              variant="codon_fused")
    tta_counts = kc.launches()
    need(tta["tta_transforms"] == 8, "the codon_fused eval did not run TTA8")
    for name, count in tta_counts.items():
        need(count == 2 * 5 * batches, f"codon_fused TTA8 eval: {name} "
             f"launched {count} times; expected {2 * 5 * batches}")
    gaps = check_device_metrics(tta, data, out)
    return summary, wall, counts, tta, tta_wall, tta_counts, gaps


def compare_fused_paths(data: str):
    """fp32 on the first batch: the merged-tower forward with the CAC
    kernels on the halves of T against its plain stage (FWD_TOL), and
    against the packed `codon` forward (the JAX test's 2e-4 / 1e-3). ->
    (max |d| kernels vs plain, max |d| fused vs packed)."""
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.codon_net import (CodonConfig, codon_forward,
                                                  codon_forward_fused)
    params = params_from_numpy(load_npz(CKPT), DEVICE)
    b = first_batch(data)
    cfg = CodonConfig(dead_heads=True)
    kern = codon_forward_fused(params, b.depth, b.color, mask=b.mask,
                               cfg=dataclasses.replace(cfg,
                                                       cac_impl="kernel"))
    plain = codon_forward_fused(params, b.depth, b.color, mask=b.mask,
                                cfg=dataclasses.replace(cfg,
                                                        cac_impl="torch"))
    packed = codon_forward(params, b.depth, b.color, mask=b.mask, cfg=cfg)
    need(bool(torch.isfinite(kern).all()), "non-finite fp32 fused forward")
    d_paths = float((kern - plain).abs().max())
    need(d_paths <= FWD_TOL, f"fp32 fused forward, kernels vs plain stage: "
         f"max abs diff {d_paths} > {FWD_TOL}")
    d_packed = float((kern - packed).abs().max())
    need(bool(torch.allclose(kern, packed, atol=FUSED_TOL[0],
                             rtol=FUSED_TOL[1])),
         f"fp32 fused forward vs packed: max abs diff {d_packed}, outside "
         f"{FUSED_TOL}")
    return d_paths, d_packed


def fused_int8_launches(kq, n, h, w):
    """{quant_im2col, dequant_epilogue} launches of one codon_fused int8
    forward of n images at h x w: a grouped site quantizes a block of
    images once, then gathers, multiplies and dequantizes each group; an
    ungrouped one runs each once a block. The GEMMs are the epilogues."""
    im2col = conv = 0
    for k, c, groups, _, calls in FUSED_INT8_CONVS:
        blocks = len(kq.image_blocks(n, h, w, k * k * c // groups))
        im2col += calls * blocks * (groups + 1 if groups > 1 else 1)
        conv += calls * blocks * groups
    return {"quant_im2col": im2col, "dequant_epilogue": conv,
            "int8_gemm": conv}


def grouped_sites():
    """The distinct grouped int8 conv shapes of a codon_fused forward,
    (k, C_in, groups, C_out, calls a forward)."""
    sites = {}
    for k, c, groups, co, calls in FUSED_INT8_CONVS:
        if groups > 1:
            sites[(k, c, groups, co)] = sites.get((k, c, groups, co), 0) + \
                calls
    return [(*key, calls) for key, calls in sites.items()]


def check_windowed_quant_kernels(kq):
    """At every grouped int8 site of the b4 codon_fused forward (one block
    of images): quant_im2col on each group's channel window (float32 and
    bfloat16 input, static and dynamic scales; int8 input, the gather
    alone) and dequant_epilogue into each group's output window (float32
    and bfloat16, static and dynamic, masked), bitwise against their plain
    versions. -> {name: [check, ...]}."""
    import torch
    checks = {"quant_im2col": [], "dequant_epilogue": []}
    n, h, w = MAIN_SHAPE[:3]
    for i, (k, c, groups, co, _) in enumerate(grouped_sites()):
        cg, cog = c // groups, co // groups
        nb = kq.image_blocks(n, h, w, k * k * cg)[0][1]
        shape = (nb, h, w, c)
        x, sc, sx, mask, _, _ = quant_inputs(shape, MAIN_VALID[:nb], 700 + i)
        for dname in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dname)
            xd = (kq.quantize_plain(x, sc) if dtype == torch.int8
                  else x.to(dtype).contiguous())
            modes = ([("none", None, None)] if dtype == torch.int8 else
                     [("channel", sc, None), ("sample", None, sx)])
            for mode, a, b in modes:
                for g in range(groups):
                    got = kq.quant_im2col(xd, k, a, b, c0=g * cg, cg=cg)
                    want = kq.quant_im2col_plain(xd, k, a, b, c0=g * cg,
                                                 cg=cg)
                    same = torch.equal(got, want)
                    checks["quant_im2col"].append(
                        {"dtype": dname, "shape": list(shape), "k": k,
                         "window": [g * cg, (g + 1) * cg], "mode": mode,
                         "bitwise": same, "ok": same, "max_abs_err": float(
                             (got.float() - want.float()).abs().max())})
                    del got, want
            del xd
        del x
        torch.cuda.empty_cache()
        gen = torch.Generator(device=DEVICE).manual_seed(750 + i)
        acc = torch.randint(-2 ** 20, 2 ** 20, (nb * h * w, cog),
                            generator=gen, device=DEVICE, dtype=torch.int32)
        sw = torch.rand((cog,), generator=gen, device=DEVICE) * 1e-3
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for mode, b in (("static", None), ("dynamic", sx)):
                for g in range(groups):
                    got = torch.zeros((nb, h, w, co), dtype=dtype,
                                      device=DEVICE)
                    want = torch.zeros_like(got)
                    kq.dequant_epilogue(acc, sw, dtype, (nb, h, w), b,
                                        mask.to(dtype), out=got, o0=g * cog)
                    kq.dequant_epilogue_plain(acc, sw, dtype, (nb, h, w), b,
                                              mask.to(dtype), out=want,
                                              o0=g * cog)
                    same = torch.equal(got, want)
                    checks["dequant_epilogue"].append(
                        {"dtype": dname, "shape": [nb, h, w, co],
                         "window": [g * cog, (g + 1) * cog], "mode": mode,
                         "mask": True, "bitwise": same, "ok": same,
                         "max_abs_err": float((got.float() - want.float())
                                              .abs().max())})
                    del got, want
        del acc
        torch.cuda.empty_cache()
    return checks


def time_windowed_quant(kq):
    """bf16, at each grouped int8 site of the b4 codon_fused forward (one
    block of images): the device time a launch of the gather of one
    group's channel window (int8 codes of all C channels in) beside the
    same gather of a contiguous cg-channel tensor, of the quantize pass
    over all C (quant_im2col at k = 1), and of dequant_epilogue into one
    group's output window beside a contiguous output; each with its byte
    bound and its launches a forward. -> [row, ...]."""
    import torch
    n, h, w = MAIN_SHAPE[:3]
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(800)
    mask = make_mask(MAIN_SHAPE, MAIN_VALID).to(bf)
    rows = []
    for k, c, groups, co, calls in grouped_sites():
        cg, cog = c // groups, co // groups
        blocks = kq.image_blocks(n, h, w, k * k * cg)
        nb = blocks[0][1]
        pix = nb * h * w
        x = (torch.randn((nb, h, w, c), generator=g, device=DEVICE) * 3
             ).to(bf)
        sc = torch.rand((c,), generator=g, device=DEVICE) * 0.05 + 0.005
        codes = kq.quantize_plain(x, sc)
        flat = codes[..., :cg].contiguous()
        acc = torch.randint(-2 ** 20, 2 ** 20, (pix, cog), generator=g,
                            device=DEVICE, dtype=torch.int32)
        sw = torch.rand((cog,), generator=g, device=DEVICE) * 1e-3
        m = mask[:nb].contiguous()
        out = torch.empty((nb, h, w, co), dtype=bf, device=DEVICE)
        launches = calls * len(blocks)
        gather_bytes = pix * cg + pix * k * k * cg
        quant_bytes = pix * c * 2 + pix * c
        ep_bytes = pix * cog * 4 + pix * 2 + pix * cog * 2
        rows.append({
            "k": k, "c_in": c, "groups": groups, "c_out": co,
            "shape": [nb, h, w, c], "launches_a_forward": {
                "gather": launches * groups, "quantize": launches,
                "epilogue": launches * groups},
            "gather_device_ms": graph_ms(
                lambda: kq.quant_im2col(codes, k, c0=cg, cg=cg)),
            "gather_contiguous_device_ms": graph_ms(
                lambda: kq.quant_im2col(flat, k)),
            "gather_bound_ms": bound(gather_bytes, 0)[0],
            "quantize_device_ms": graph_ms(
                lambda: kq.quant_im2col(x, 1, sc)),
            "quantize_bound_ms": bound(quant_bytes, x.numel())[0],
            "epilogue_device_ms": graph_ms(
                lambda: kq.dequant_epilogue(acc, sw, bf, (nb, h, w), None, m,
                                            out=out, o0=cog)),
            "epilogue_contiguous_device_ms": graph_ms(
                lambda: kq.dequant_epilogue(acc, sw, bf, (nb, h, w), None,
                                            m)),
            "epilogue_bound_ms": bound(ep_bytes, 3 * pix * cog)[0]})
        del x, codes, flat, acc, out
        torch.cuda.empty_cache()
    return rows


def run_fused_int8_path(kc, kq, data: str, tmp: str):
    """`cli eval --variant codon_fused --dtype int8` with
    x4_ship4_qat_static (its compound sites resolve through the aliases),
    the counts set to 0 just before and read just after."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    out = os.path.join(tmp, "fused_int8")
    reset_counts(kc, kq)
    summary, wall = eval_once(data, out, out + ".json", 4, ckpt=CKPT_INT8,
                              dtype="int8", variant="codon_fused")
    counts = read_counts(kc, kq)
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the codon_fused int8 eval did not score every image")
    want = {k: batches * v for k, v in
            fused_int8_launches(kq, *MAIN_SHAPE[:3]).items()}
    want.update({k: 5 * batches for k in kc.launches()})
    for name, n in want.items():
        need(counts[name] == n, f"codon_fused int8 eval: {name} launched "
             f"{counts[name]} times; expected {n}")
    return summary, wall, counts


def compare_fused_int8_paths(data: str):
    """fp32 int8 codon_fused forward of the first batch (x4_ship4_qat_
    static), the quant kernels against their plain versions, the CAC
    kernels in both, under cuDNN's deterministic mode: bitwise. -> max
    |d|."""
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.variants import get_variant
    tree = load_npz(CKPT_INT8)
    tree.pop("act_scales")
    params = params_from_numpy(tree, DEVICE)
    b = first_batch(data)
    v = get_variant("codon_fused")
    cfg = dataclasses.replace(v.cfg, cac_impl="kernel")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = [v.forward_fn(params, b.depth, b.color, mask=b.mask, cfg=cfg,
                             ops=static_int8_ops(torch.float32, impl))
                for impl in (None, "plain")]
    finally:
        torch.backends.cudnn.deterministic = saved
    need(bool(torch.isfinite(outs[0]).all()),
         "non-finite fp32 fused int8 forward")
    diff = float((outs[0] - outs[1]).abs().max())
    need(torch.equal(outs[0], outs[1]), f"fp32 fused int8 forward, quant "
         f"kernels vs plain: max abs diff {diff}, not bitwise")
    return diff


# ---------------------------------------------------------------------------
# phase 21: the sequential-tower forward (rmcr_fuse_rmcr)
# ---------------------------------------------------------------------------

def run_sequential_path(kc, kq, data: str, tmp: str):
    """`cli eval --variant rmcr_fuse_rmcr` in bf16 (no CAC kernel may
    launch) and in int8 with x4_ship4_qat_static (the quant kernels at
    each of its 43 convs a forward, no handoffs), each with the counts set
    to 0 just before and read just after."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    runs = {}
    for dtype, ckpt in (("bf16", CKPT), ("int8", CKPT_INT8)):
        out = os.path.join(tmp, f"rmcr_{dtype}")
        reset_counts(kc, kq)
        summary, wall = eval_once(data, out, out + ".json", 4, ckpt=ckpt,
                                  dtype=dtype, variant="rmcr_fuse_rmcr")
        counts = read_counts(kc, kq)
        need(len(summary["per_image"]) == n_images and
             all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
                 for r in summary["per_image"]),
             f"the rmcr_fuse_rmcr {dtype} eval did not score every image")
        conv = (batches * int8_launches(kq, *MAIN_SHAPE[:3])
                if dtype == "int8" else 0)
        need_int8_counts(counts, 0, conv, 0, f"rmcr_fuse_rmcr {dtype} eval")
        runs[dtype] = (summary, wall, counts)
    return runs


# ---------------------------------------------------------------------------
# phase 22: the rest of the cli
# ---------------------------------------------------------------------------

def cli_said(argv):
    """-> (return code, what `cli.main(argv)` printed)."""
    import contextlib
    import io
    from codon_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def run_cli_tools(data: str, tmp: str, main_out: str, main_summary):
    """`eval --resume` twice (the second finds every PNG and writes the
    all-done stub), `eval --profile`, `eval --check-nans` on x4_ship4 with
    one NaN weight (it must fail through FloatingPointError naming the
    site), `golden` on the main eval's PNGs, and `info`. -> a dict of what
    each showed."""
    import shutil
    import numpy as np
    from codon_tpu_torch.checkpoint.native import load_npz, save_npz
    res = {}
    out = os.path.join(tmp, "resume")
    first, _ = eval_once(data, out, out + "1.json", 4, ["--resume"])
    need(first["images"] == len(SCENES) and "resumed_all" not in first,
         "the first --resume eval did not run every image")
    stub, _ = eval_once(data, out, out + "2.json", 4, ["--resume"])
    need(stub.get("resumed_all") is True and stub["images"] == 0
         and stub["mean_rmse"] is None
         and set(stub) == set(first) | {"resumed_all"},
         f"the second --resume eval wrote no all-done stub: {stub}")
    res["resume"] = {"first_images": first["images"], "stub": stub}

    prof = os.path.join(tmp, "profile")
    eval_once(data, os.path.join(tmp, "prof_out"), prof + ".json", 4,
              ["--profile", prof, "--no-save"])
    trace = os.path.join(prof, "trace.json")
    need(os.path.exists(trace), "--profile wrote no trace")
    with open(trace) as f:
        text = f.read()
    need("cac_apply_kernel" in text, "the --profile trace holds no CAC "
         "kernel launch")
    res["profile_trace_bytes"] = len(text)

    bad = os.path.join(tmp, "x4_ship4_nan.npz")
    tree = load_npz(CKPT)
    tree["conv3"] = tree["conv3"].copy()
    tree["conv3"][1, 2, 3, 4] = np.nan
    save_npz(bad, tree)
    try:
        eval_once(data, os.path.join(tmp, "nan_out"), bad + ".json", 4,
                  ["--check-nans"], ckpt=bad)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    need(raised is not None and "conv site 'conv3'" in raised,
         f"--check-nans on a NaN conv3 weight: {raised!r}")
    res["check_nans"] = raised

    gdir = os.path.join(tmp, "golden", "CODON_X4")
    shutil.copytree(os.path.join(data, "input_label"),
                    os.path.join(gdir, "input_label"))
    shutil.copytree(main_out, os.path.join(gdir, "output"))
    rc, said = cli_said(["golden", "--data-dir", gdir])
    lines = said.strip().splitlines()
    need(rc == 0 and lines[-2] == str(len(SCENES)),
         f"golden printed {lines[-2:]}")
    g_rmse, g_ssim = (float(v) for v in lines[-1].split())
    need(g_rmse == main_summary["mean_rmse"]
         and g_ssim == main_summary["mean_ssim"],
         f"golden on the main eval's PNGs: {g_rmse} {g_ssim}, the eval "
         f"scored {main_summary['mean_rmse']} {main_summary['mean_ssim']}")
    res["golden"] = lines[-1]

    rc, said = cli_said(["info"])
    need(rc == 0 and "variant 'codon': 1,866,136 params" in said
         and "codon_fused" in said and "rmcr_fuse_rmcr" in said,
         f"info printed {said!r}")
    res["info"] = said.strip().splitlines()
    return res


# ---------------------------------------------------------------------------
# phases 23-26: training on the card
# ---------------------------------------------------------------------------

def train_batch(data: str, step: int = 0, patch: int = TRAIN_PATCH,
                batch: int = TRAIN_BATCH):
    """The patch batch `cli train` draws at `step` from the scale dir (b16
    p64 unless told, seed 0, the shipped degradation), on the card."""
    import torch
    from codon_tpu_torch.data.io import discover_pairs, imread_gray
    from codon_tpu_torch.data.pipeline import to_device
    from codon_tpu_torch.train.data import PatchSampler
    names = discover_pairs(data)
    imgs = {sub: [imread_gray(os.path.join(data, sub, n + ".png"))
                  for n in names]
            for sub in ("input_label", "input_color", "input_depth")}
    sampler = PatchSampler(imgs["input_label"], imgs["input_color"],
                           scale=4, patch=patch, batch=batch,
                           degraded=imgs["input_depth"])
    dev = torch.device(DEVICE)
    return sampler, {k: to_device(v, dev)
                     for k, v in sampler.sample_at(step).items()}


def train_step_for(dtype: str, cac_impl=None, ops=None, mesh=None,
                   variant: str = "codon"):
    import dataclasses
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.trainer import TrainConfig, make_train_step
    v = get_variant(variant, DTYPE_POLICIES[dtype])
    if cac_impl is not None:
        v = dataclasses.replace(v, cfg=dataclasses.replace(
            v.cfg, cac_impl=cac_impl))
    return make_train_step(v, TrainConfig(clip_norm=1.0), ops=ops,
                           mesh=mesh)


def ship4_params():
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    return params_from_numpy(load_npz(CKPT), DEVICE)


def grad_distance(a, b, paths, variant: str = "codon"):
    """-> (the gradient tree's relative L2 distance |a - b| / |b|, the
    worst leaf's max |a - b| over its max |b|, that leaf), over the leaves
    the variant's forward reads."""
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.trainer import top_name
    unread = get_variant(variant).unread
    num = den = worst = 0.0
    worst_path = None
    for path, x, y in zip(paths, a, b):
        if top_name(path) in unread:
            continue
        d = (x.float() - y.float())
        num += float((d * d).sum())
        den += float((y.float() * y.float()).sum())
        rel = float(d.abs().max()) / max(float(y.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_path = rel, path
    return (num / den) ** 0.5, worst, worst_path


def compare_train_grads(kc, data: str):
    """Phase 23: one training step's loss and gradients, the forward's CAC
    stage through the kernels (CacStageFunction) against the plain stage,
    fp32 then bf16, b16 p64, x4_ship4's weights -> a row a dtype. bf16 is
    also measured against the fp32 plain step."""
    import torch
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.trainer import top_name, tree_items
    unread = get_variant("codon").unread
    params = ship4_params()
    _, batch = train_batch(data)
    paths = [p for p, _ in tree_items(params)]
    rows, ref = [], None
    for dtype in ("fp32", "bf16"):
        kstep, _ = train_step_for(dtype)
        kc.reset_launches()
        lk, gk = kstep.value_and_grad(params, batch)
        torch.cuda.synchronize()
        counts = kc.launches()
        need(counts == {k: 5 for k in counts},
             f"{dtype} training step launched {counts}: expected 5 of each "
             f"CAC kernel in the forward and none in the backward")
        tstep, _ = train_step_for(dtype, cac_impl="torch")
        kc.reset_launches()
        lt, gt = tstep.value_and_grad(params, batch)
        torch.cuda.synchronize()
        need(sum(kc.launches().values()) == 0,
             "the plain-stage step launched a CAC kernel")
        dead = [p for p, g in zip(paths, gk) if float(g.abs().max()) == 0]
        need(dead == [p for p in paths if top_name(p) in unread],
             f"{dtype}: leaves without a gradient: {dead}")
        tree, worst, worst_path = grad_distance(gk, gt, paths)
        loss_rel = abs(float(lk) - float(lt)) / abs(float(lt))
        loss_tol, leaf_tol, tree_tol = TRAIN_TOLS[dtype]
        need(math.isfinite(float(lk)) and loss_rel <= loss_tol,
             f"{dtype} loss: kernels {float(lk)} vs plain {float(lt)}")
        need(worst <= leaf_tol and tree <= tree_tol,
             f"{dtype} gradients: tree {tree:.3e} (> {tree_tol}?), leaf "
             f"{worst_path} {worst:.3e} of its max |g| (> {leaf_tol}?)")
        row = {"dtype": dtype, "loss_kernels": float(lk),
               "loss_plain": float(lt), "loss_rel": loss_rel,
               "grad_tree_rel": tree, "grad_worst_rel": worst,
               "grad_worst_leaf": worst_path, "leaves": len(paths),
               "launches": counts}
        if ref is None:
            ref = gt
        else:
            # the kernel step no farther from the fp32 gradient than the
            # plain bf16 step is, within BF16_CLASS
            row["kernels_vs_fp32"] = grad_distance(gk, ref, paths)[0]
            row["plain_vs_fp32"] = grad_distance(gt, ref, paths)[0]
            need(row["kernels_vs_fp32"] <= BF16_CLASS * row["plain_vs_fp32"],
                 f"bf16 kernel step {row['kernels_vs_fp32']:.3e} from the "
                 f"fp32 gradient, the plain bf16 step "
                 f"{row['plain_vs_fp32']:.3e}")
        rows.append(row)
    return rows


class _Interrupt(Exception):
    pass


def train_cli(kc, argv, stop_after=None, record=None):
    """One in-process `cli train` on the card with the CAC counters set
    to 0 just before and read just after -> (stdout, counts, wall s).
    stop_after: raise out of the run right after that step's checkpoint
    (an interrupt). record: a list that receives a digest of every batch
    the run draws."""
    import contextlib
    import hashlib
    import io
    from codon_tpu_torch import cli
    from codon_tpu_torch.checkpoint import manager
    from codon_tpu_torch.train import data as tdata
    real_save, real_sample = (manager.CheckpointManager.save,
                              tdata.PrefetchSampler.sample)

    def save(self, step, tree):
        real_save(self, step, tree)
        if step == stop_after:
            raise _Interrupt

    def sample(self):
        b = real_sample(self)
        if record is not None:
            record.append(hashlib.sha256(b"".join(
                b[k].tobytes() for k in sorted(b))).hexdigest())
        return b

    manager.CheckpointManager.save = save
    tdata.PrefetchSampler.sample = sample
    buf = io.StringIO()
    kc.reset_launches()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            try:
                rc = cli.main(["train", "--device", DEVICE, *argv])
            except _Interrupt:
                rc = "interrupted"
    finally:
        manager.CheckpointManager.save = real_save
        tdata.PrefetchSampler.sample = real_sample
    wall = time.time() - t0
    counts = kc.launches()
    need(rc in (0, "interrupted"), f"cli train returned {rc}")
    return buf.getvalue(), counts, wall


def need_train_counts(counts, steps, what):
    need(counts == {k: 5 * steps for k in counts},
         f"{what}: CAC launches {counts} in {steps} steps; expected "
         f"{5 * steps} of each (5 stages a forward, none in the backward)")


def train_losses(out: str):
    import re
    losses = [float(x) for x in re.findall(r"loss ([0-9.eE+-]+)", out)]
    need(losses and all(math.isfinite(x) for x in losses),
         f"cli train logged no finite loss: {out[-500:]}")
    return losses


def run_train_path(kc, kq, data: str, tmp: str):
    """Phase 24: `cli train` on the card, b16 p64 bf16 from x4_ship4: 30
    steps with warmup, clip and EMA, checkpoints every 10; the same run
    interrupted after step 10 and resumed; --qat-static from
    x4_ship4_qat_static.npz, scored by `cli eval --dtype int8`; and a run
    on synthesized degradation (no input_depth/)."""
    import shutil
    import numpy as np
    from codon_tpu_torch.checkpoint.native import load_npz
    from codon_tpu_torch.train.trainer import tree_items
    steps = TRAIN_STEPS
    common = ["--data-dir", data, "--ckpt-in", CKPT, "--steps", str(steps),
              "--batch", str(TRAIN_BATCH), "--patch", str(TRAIN_PATCH),
              "--warmup", "5", "--clip-norm", "1", "--ema", "0.999",
              "--save-every", "10", "--log-every", "10"]
    res = {}
    full, ck_a = [], os.path.join(tmp, "train_a.npz")
    out, counts, wall = train_cli(kc, [*common, "--orbax-dir",
                                       os.path.join(tmp, "orbax_a"),
                                       "--ckpt-out", ck_a], record=full)
    need_train_counts(counts, steps, "cli train")
    need(len(full) == steps, f"{len(full)} batches drawn in {steps} steps")
    res["train"] = {"losses": train_losses(out), "counts": counts,
                    "wall_s": wall}
    # interrupted after the step-10 checkpoint, then resumed to the end
    ck_b, odir_b = os.path.join(tmp, "train_b.npz"), os.path.join(
        tmp, "orbax_b")
    _, c1, _ = train_cli(kc, [*common, "--orbax-dir", odir_b, "--ckpt-out",
                              ck_b], stop_after=10)
    need_train_counts(c1, 10, "cli train up to the interrupt")
    resumed = []
    out_r, c2, _ = train_cli(kc, [*common, "--orbax-dir", odir_b,
                                  "--ckpt-out", ck_b], record=resumed)
    need("resumed step 10" in out_r, "the second run did not resume")
    need_train_counts(c2, steps - 10, "the resumed cli train")
    need(resumed == full[10:], "the resumed run drew other batches than "
         "the uninterrupted one")
    a, b = load_npz(ck_a), load_npz(ck_b)
    diff = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))
    bound = RESUME_BOUND_LRS * 1e-4 * (steps - 10)
    need(diff <= bound, f"resumed params differ by {diff} > {bound}")
    res["resume"] = {"max_abs_diff": diff, "bound": bound,
                     "batches_bitwise": True}
    # --qat-static, then the int8 eval of what it wrote
    ck_q = os.path.join(tmp, "train_q.npz")
    out_q, cq, wall_q = train_cli(kc, [
        "--data-dir", data, "--ckpt-in", CKPT_INT8, "--qat-static",
        "--batch", str(TRAIN_BATCH), "--patch", str(TRAIN_PATCH),
        "--steps", "10", "--log-every", "5", "--ckpt-out", ck_q])
    need("QAT-static: calibrated 18 conv sites" in out_q,
         "--qat-static did not calibrate 18 sites")
    # the calibration's eval forwards launch the kernels too: 8 frames at
    # batch 2, 5 stages each
    cal = 5 * -(-len(SCENES) // 2)
    need(cq == {k: 5 * 10 + cal for k in cq},
         f"cli train --qat-static: CAC launches {cq}; expected "
         f"{5 * 10 + cal} of each (10 steps and {cal // 5} calibration "
         f"batches)")
    need(len(load_npz(ck_q).get("act_scales", {})) == 18,
         "--qat-static wrote no act_scales")
    kq.reset_launches()
    i8, _ = eval_once(data, os.path.join(tmp, "out_q"),
                      os.path.join(tmp, "eval_q.json"), 4, ckpt=ck_q,
                      dtype="int8")
    need(all(math.isfinite(i8[k]) for k in ("mean_rmse", "mean_ssim")),
         "the int8 eval of the QAT output is not finite")
    need(kq.launches()["quant_im2col"] > 0, "the int8 eval ran no quant "
         "kernel")
    res["qat_static"] = {"losses": train_losses(out_q), "counts": cq,
                         "wall_s": wall_q, "int8_rmse": i8["mean_rmse"],
                         "int8_ssim": i8["mean_ssim"]}
    # synthesized degradation: the scale dir without input_depth/
    syn = os.path.join(tmp, "CODON_X4_syn")
    for sub in ("input_color", "input_label"):
        shutil.copytree(os.path.join(data, sub), os.path.join(syn, sub))
    out_s, cs, wall_s = train_cli(kc, [
        "--data-dir", syn, "--ckpt-in", CKPT, "--steps", "5",
        "--batch", str(TRAIN_BATCH), "--patch", str(TRAIN_PATCH),
        "--log-every", "1", "--ckpt-out", os.path.join(tmp, "train_s.npz")])
    need("[synthesized degradation]" in out_s, "the run did not synthesize")
    need_train_counts(cs, 5, "cli train on synthesized degradation")
    res["synthesized"] = {"losses": train_losses(out_s), "wall_s": wall_s}
    return res


def time_training(kc, data: str):
    """Phases 25-26: a step's time at b16 p64 in bf16 and fp32 (CUDA
    events over back-to-back steps on one batch on the card), split into
    forward, backward and optimizer; the host sampler's ms a batch; and
    the device's idle share over 10 steps of the loop `cli train` runs
    (prefetch thread, pinned copy, step) from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from codon_tpu_torch.core.params import full_fp32
    from codon_tpu_torch.data.pipeline import to_device
    from codon_tpu_torch.train.trainer import tree_items, tree_rebuild
    sampler, batch = train_batch(data)
    res = {}
    for dtype in ("bf16", "fp32"):
        params = ship4_params()
        step, opt = train_step_for(dtype)
        state = opt.init(params)
        for _ in range(3):
            params, state, m = step(params, state, batch)
        step_ms = time_ms(lambda: step(params, state, batch), warmup=0,
                          iters=TIME_ITERS)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
        for _ in range(TIME_ITERS):
            leaves = [t.detach().requires_grad_(True)
                      for _, t in tree_items(params)]
            ev[0].record()
            with torch.enable_grad(), full_fp32():
                loss = step.loss(tree_rebuild(params, leaves), batch)
                ev[1].record()
                grads = torch.autograd.grad(loss, leaves,
                                            allow_unused=True)
            ev[2].record()
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
            state = opt.update(grads, state, params)
            ev[3].record()
            torch.cuda.synchronize()
            for k, (a, b) in zip(split, zip(ev, ev[1:])):
                split[k] += a.elapsed_time(b) / TIME_ITERS
        res[dtype] = {"step_ms": step_ms,
                      "patches_per_s": TRAIN_BATCH * 1e3 / step_ms,
                      "split_ms": split}
    t0 = time.perf_counter()
    for i in range(TIME_ITERS):
        sampler.sample_at(100 + i)
    res["sampler_ms"] = (time.perf_counter() - t0) * 1e3 / TIME_ITERS
    # the loop of cli train, bf16, profiled
    params = ship4_params()
    step, opt = train_step_for("bf16")
    state = opt.init(params)
    pf = sampler.prefetch(2, 0)
    try:
        dev = torch.device(DEVICE)
        for _ in range(3):
            b = {k: to_device(v, dev) for k, v in pf.sample().items()}
            params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TIME_ITERS):
                b = {k: to_device(v, dev) for k, v in pf.sample().items()}
                params, state, m = step(params, state, b)
            float(m["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pf.close()
    busy = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            busy += t / 1e3
    need(busy > 0, "the profiler saw no device time in the training loop")
    res["loop"] = {"steps": TIME_ITERS, "wall_ms_a_step": wall_ms /
                   TIME_ITERS, "device_ms_a_step": busy / TIME_ITERS,
                   "idle_share": max(0.0, 1.0 - busy / wall_ms)}
    return res


# ---------------------------------------------------------------------------
# phases 27-31: the ablation zoo
# ---------------------------------------------------------------------------

def zoo_batch(data: str):
    """The zoo's cell batch: the scale dir's second batch of 4, two scenes
    of 463 x 370 and two of 450 x 375, padded to 480 x 384 with a mask."""
    from codon_tpu_torch.data.io import discover_pairs, load_sample
    from codon_tpu_torch.data.pipeline import make_batch
    names = discover_pairs(data)[4:8]
    b = make_batch([load_sample(data, n) for n in names], 32, DEVICE,
                   fixed_hw=MAIN_SHAPE[1:3])
    need(sorted(set(b.sizes)) == sorted(set(ZOO_SIZES)),
         f"the zoo batch holds sizes {b.sizes}, expected {ZOO_SIZES}")
    return b


def zoo_params(name, device=None):
    """Zoo net `name`'s own init from ZOO_SEED (on the card unless `device`
    says otherwise): what `cli eval` and `cli train` draw without a
    checkpoint."""
    import torch
    from codon_tpu_torch.models.variants import get_variant
    return get_variant("zoo:" + name).init(
        torch.Generator().manual_seed(ZOO_SEED), device or DEVICE)


def run_zoo_nets(kc, kq, data: str):
    """Phase 27: each of the 27 zoo nets at the cell shape, its own init:
    fp32 and bf16 forwards (finite, bf16 within ZOO_BF16_REL of fp32), no
    hand-written kernel launched (the counts set to 0 before and read
    after); for the nets with a global reduction, the masked batch against
    each image alone; the device ms of a forward in each dtype. Yields a
    row a net as it goes."""
    import torch
    from codon_tpu_torch.core.params import BF16
    from codon_tpu_torch.models import zoo
    from codon_tpu_torch.models.variants import get_variant
    b = zoo_batch(data)
    valid = b.mask[..., 0] > 0
    for name in zoo.list_zoo():
        v32, vbf = get_variant("zoo:" + name), get_variant("zoo:" + name,
                                                           BF16)
        params = zoo_params(name)

        def fwd(v):
            return v.forward(params, b.depth, b.color, mask=b.mask)
        reset_counts(kc, kq)
        y32, ybf = fwd(v32), fwd(vbf)
        torch.cuda.synchronize()
        counts = read_counts(kc, kq)
        need(sum(counts.values()) == 0,
             f"zoo:{name} launched {counts}: the zoo's float path has no "
             f"hand-written kernel")
        need(bool(torch.isfinite(y32).all() and torch.isfinite(ybf).all()),
             f"zoo:{name}: non-finite forward")
        scale = float(y32[valid].abs().mean())
        rel = float((ybf - y32)[valid].abs().mean()) / scale
        need(rel <= ZOO_BF16_REL, f"zoo:{name}: bf16 mean |d| {rel:.3e} of "
             f"the fp32 output's mean |y|, > {ZOO_BF16_REL}")
        row = {"name": name, "bf16_rel_mean": rel, "mean_abs_y": scale,
               "params": sum(t.numel() for t in params.values())}
        if name in ZOO_GLOBAL:
            worst = 0.0
            atol, rtol = ZOO_IMAGE_TOL
            for i, (h, w) in enumerate(b.sizes):
                alone = v32.forward(params,
                                    b.depth[i:i + 1, :h, :w].contiguous(),
                                    b.color[i:i + 1, :h, :w].contiguous())
                d = float((y32[i:i + 1, :h, :w] - alone).abs().max())
                lim = atol + rtol * float(alone.abs().max())
                need(d <= lim, f"zoo:{name}: image {i} of the masked batch "
                     f"differs from the image alone by {d} > {lim}")
                worst = max(worst, d)
            row["per_image_max_abs_diff"] = worst
        row["bf16_ms"] = time_ms(lambda: fwd(vbf), warmup=1, iters=5)
        row["fp32_ms"] = time_ms(lambda: fwd(v32), warmup=0, iters=2)
        del params, y32, ybf
        yield row


def compare_zoo_codon(kc, data: str):
    """Phase 28: the zoo's CODONNet entry on x4_ship4 (carried across as the
    reference's state dict, then by rank) against `codon` with the CAC
    kernels, fp32 and bf16, on the main path's first batch; CAC launches
    counted over both dtypes' forwards: none on the zoo path, 5 a forward
    on codon's."""
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.checkpoint.torch_convert import (
        generic_state_dict_to_flat, params_to_torch_state_dict)
    from codon_tpu_torch.core.params import BF16, FP32
    from codon_tpu_torch.models.variants import get_variant
    tree = load_npz(CKPT)
    flat = generic_state_dict_to_flat(params_to_torch_state_dict(
        tree, get_variant("codon").cfg))
    zp, cp = params_from_numpy(flat, DEVICE), params_from_numpy(tree, DEVICE)
    b = first_batch(data)
    res, zoo_counts, codon_counts = {}, None, None
    for label, dt in (("fp32", FP32), ("bf16", BF16)):
        kc.reset_launches()
        yz = get_variant("zoo:" + ZOO_CODON, dt).forward(
            zp, b.depth, b.color, mask=b.mask)
        torch.cuda.synchronize()
        cz = kc.launches()
        kc.reset_launches()
        yc = get_variant("codon", dt).forward(cp, b.depth, b.color,
                                              mask=b.mask)
        torch.cuda.synchronize()
        cc = kc.launches()
        zoo_counts = cz if zoo_counts is None else {
            k: zoo_counts[k] + v for k, v in cz.items()}
        codon_counts = cc if codon_counts is None else {
            k: codon_counts[k] + v for k, v in cc.items()}
        need(bool(torch.isfinite(yz).all()), f"zoo CODON {label}: "
             f"non-finite")
        res[label] = float((yz - yc).abs().max())
    need(res["fp32"] <= FWD_TOL, f"zoo CODON vs codon fp32: {res['fp32']} > "
         f"{FWD_TOL}")
    need(res["bf16"] <= ZOO_CODON_BF16_ATOL, f"zoo CODON vs codon bf16: "
         f"{res['bf16']} > {ZOO_CODON_BF16_ATOL}")
    need(all(v == 0 for v in zoo_counts.values()),
         f"the zoo's CODON launched CAC kernels: {zoo_counts}")
    need(all(v == 10 for v in codon_counts.values()),
         f"codon launched {codon_counts}: expected 10 of each (5 stages, "
         f"two forwards)")
    return res, zoo_counts, codon_counts


def run_zoo_evals(kc, kq, data: str, tmp: str):
    """Phase 29: `cli eval --variant zoo:<net> --tta8 --device-metrics`
    (bf16, b4, the net's own init) for ZOO_EVAL_NETS, the counts set to 0
    just before and read just after each: none launches a kernel."""
    runs = {}
    for name in ZOO_EVAL_NETS:
        out = os.path.join(tmp, f"zoo_{name}")
        reset_counts(kc, kq)
        summary, wall = eval_once(data, out, out + ".json", 4,
                                  ["--tta8", "--device-metrics"], ckpt=None,
                                  variant="zoo:" + name)
        counts = read_counts(kc, kq)
        need(len(summary["per_image"]) == len(SCENES) and
             all(math.isfinite(summary[k])
                 for k in ("mean_rmse", "mean_ssim")),
             f"the zoo:{name} eval did not score every image")
        need(summary["tta_transforms"] == 8, "the zoo eval ran no TTA8")
        need(sum(counts.values()) == 0, f"the zoo:{name} eval launched "
             f"{counts}")
        runs[name] = (summary, wall, counts)
    return runs


def zoo_int8_calls(name):
    """(k, C_in a group, groups, pooled) of each quantized conv call of one
    forward of zoo net `name`, recorded on the CPU (pooled: the CALayer's
    1 x 1 convs on a (N, 1, 1, C) vector)."""
    import torch
    from codon_tpu_torch.core.ops import TorchOps
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import _skip_quant
    calls = []

    class Record(TorchOps):
        def conv2d(self, x, w, *, mask=None, groups=1, name=None):
            if not _skip_quant(w):
                calls.append((w.shape[0], w.shape[2], groups,
                              tuple(x.shape[1:3]) == (1, 1)))
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)

    v = get_variant("zoo:" + name)
    v.forward(zoo_params(name, "cpu"), torch.rand(1, 9, 7, 1),
              torch.rand(1, 9, 7, 1), ops=Record())
    return calls


def zoo_int8_launches(kq, calls, n, h, w):
    """The quant launches of one dynamic int8 forward of n images at h x w:
    at each call, a block of images takes a quantize-gather, a GEMM and an
    epilogue, a grouped call a quantize of all C and each group's own
    three; a narrow group's widths padded to 16 input channels first."""
    out = dict.fromkeys(("quant_im2col", "dequant_epilogue", "int8_gemm"), 0)
    for k, cg, groups, pooled in calls:
        cgp = -(-cg // 16) * 16
        hh, ww = (1, 1) if pooled else (h, w)
        blocks = len(kq.image_blocks(n, hh, ww, k * k * cgp))
        out["quant_im2col"] += blocks * (groups + (groups > 1))
        out["dequant_epilogue"] += blocks * groups
        out["int8_gemm"] += blocks * groups
    return out


def run_zoo_int8(kc, kq, data: str, tmp: str):
    """Phase 30: for ZOO_INT8_NETS (their narrow sites: RCAN's 64 -> 4 ->
    64 gate on the pooled vector, CGNL's grouped z with 4 channels a
    group), the fp32 dynamic int8 forward of the zoo batch through the
    quant kernels against their plain versions (cuDNN deterministic):
    bitwise; then `cli eval --dtype int8` with the counts set to 0 just
    before and read just after, against the launches each call should
    make."""
    import torch
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8Ops
    b = zoo_batch(data)
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    res = {}
    for name in ZOO_INT8_NETS:
        params = zoo_params(name)
        v = get_variant("zoo:" + name)
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            outs = [v.forward(params, b.depth, b.color, mask=b.mask,
                              ops=Int8Ops(quant_impl=impl))
                    for impl in (None, "plain")]
        finally:
            torch.backends.cudnn.deterministic = saved
        need(bool(torch.isfinite(outs[0]).all()),
             f"zoo:{name}: non-finite fp32 int8 forward")
        d_plain = float((outs[0] - outs[1]).abs().max())
        need(torch.equal(outs[0], outs[1]), f"zoo:{name} fp32 int8 forward, "
             f"quant kernels vs plain: max abs diff {d_plain}, not bitwise")
        calls = zoo_int8_calls(name)
        narrow = sum(1 for k, cg, g, pooled in calls if cg % 16 or pooled)
        want = {k: batches * v for k, v in zoo_int8_launches(
            kq, calls, *MAIN_SHAPE[:3]).items()}
        out = os.path.join(tmp, f"zoo_{name}_int8")
        reset_counts(kc, kq)
        summary, wall = eval_once(data, out, out + ".json", 4, ckpt=None,
                                  dtype="int8", variant="zoo:" + name)
        counts = read_counts(kc, kq)
        need(len(summary["per_image"]) == n_images and
             all(math.isfinite(summary[k])
                 for k in ("mean_rmse", "mean_ssim")),
             f"the zoo:{name} int8 eval did not score every image")
        for k in ("cac_stats", "spatial_logits", "cac_apply"):
            need(counts[k] == 0, f"zoo:{name} int8 eval launched {k}")
        for k, n in want.items():
            need(counts[k] == n, f"zoo:{name} int8 eval: {k} launched "
                 f"{counts[k]} times; expected {n}")
        res[name] = {"summary": summary, "wall_s": wall, "counts": counts,
                     "fp32_kernels_vs_plain": d_plain,
                     "quantized_calls_a_forward": len(calls),
                     "narrow_calls_a_forward": narrow}
        del params, outs
    return res


def run_zoo_train(kc, data: str, tmp: str):
    """Phase 31: `cli train --variant zoo:<net>` (bf16, b16 p64, the net's
    own init, weight decay on) for ZOO_TRAIN_NETS: finite losses that
    fall (the last half's mean below the first half's), no CAC launch, and
    every unread leaf moved by the weight decay alone (Adam's update of a
    zero gradient is 0), every other leaf trained."""
    import numpy as np
    from codon_tpu_torch.checkpoint.native import load_npz
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.trainer import top_name
    lr = 1e-4                        # cli train's default
    res = {}
    for name in ZOO_TRAIN_NETS:
        ck = os.path.join(tmp, f"zoo_train_{name}.npz")
        out, counts, wall = train_cli(kc, [
            "--data-dir", data, "--variant", "zoo:" + name,
            "--steps", str(ZOO_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--patch", str(TRAIN_PATCH), "--log-every", "1",
            "--weight-decay", str(ZOO_WEIGHT_DECAY), "--ckpt-out", ck])
        losses = train_losses(out)
        half = ZOO_TRAIN_STEPS // 2
        need(len(losses) == ZOO_TRAIN_STEPS and
             sum(losses[half:]) < sum(losses[:half]),
             f"zoo:{name} training losses {losses} do not fall")
        need(sum(counts.values()) == 0, f"zoo:{name} training launched "
             f"{counts}")
        init = {k: t.numpy() for k, t in zoo_params(name, "cpu").items()}
        final = load_npz(ck)
        unread = get_variant("zoo:" + name).unread
        decay = (1.0 - lr * ZOO_WEIGHT_DECAY) ** ZOO_TRAIN_STEPS
        worst, trained = 0.0, 0
        for k, p0 in init.items():
            p1 = np.asarray(final[k], np.float64)
            if top_name(k) in unread:
                d = np.abs(p1 - p0.astype(np.float64) * decay)
                need(bool((d <= 1e-6 * np.abs(p0) + 1e-12).all()),
                     f"zoo:{name}: unread leaf {k} moved by {d.max()} "
                     f"beyond its weight decay")
                worst = max(worst, float(d.max()))
            elif np.abs(p1 - p0 * decay).max() > 1e-6 * np.abs(p0).max():
                trained += 1
        read = sum(1 for k in init if top_name(k) not in unread)
        need(trained == read, f"zoo:{name}: {read - trained} read leaves did "
             f"not train")
        res[name] = {"losses": losses, "wall_s": wall, "counts": counts,
                     "unread_leaves": sum(1 for k in init
                                          if top_name(k) in unread),
                     "unread_max_abs_diff": worst}
    return res


def run_batch1_step(kc, data: str):
    """The batch-1 bf16 training step of `codon` on the card, from
    x4_ship4, through the CAC kernels: finite loss and gradient norm, 5
    launches of each CAC kernel (counts set to 0 just before)."""
    import torch
    sampler, _ = train_batch(data)
    dev = torch.device(DEVICE)
    batch = {k: torch.from_numpy(v[:1]).to(dev)
             for k, v in sampler.sample_at(0).items()}
    step, opt = train_step_for("bf16")
    params = ship4_params()
    state = opt.init(params)
    kc.reset_launches()
    params, state, m = step(params, state, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    counts = kc.launches()
    need(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
         f"batch-1 step: loss {loss}, grad_norm {gnorm}")
    need(counts == {k: 5 for k in counts}, f"batch-1 step launched "
         f"{counts}: expected 5 of each CAC kernel")
    return {"loss": loss, "grad_norm": gnorm, "counts": counts}


# ---------------------------------------------------------------------------
# phase 32: export and serve
# ---------------------------------------------------------------------------

# run by a fresh interpreter: the model code and what the card's machine
# lacks are blocked, so the artifacts must run on the custom ops alone;
# argv[1] names a JSON list of {name, path, requests, out}
SERVE_RUN = r"""
import json, sys, time
for name in {blocked!r}:
    sys.modules[name] = None          # any import of these now raises
sys.path.insert(0, {repo!r})
import torch
torch.backends.cudnn.deterministic = True
tf32 = torch.backends.cudnn.allow_tf32
from codon_tpu_torch.kernels import cac as kc, quant as kq
from codon_tpu_torch.serve import load_exported


def time_ms(fn, warmup=2, iters=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def latency_ms(fn, n=5):
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[n // 2]


results = {{}}
for job in json.load(open(sys.argv[1])):
    fn = load_exported(job["path"])
    outs, counts, reqs = [], [], []
    for args in torch.load(job["requests"]):
        args = [t.cuda() for t in args]
        reqs.append(args)
        kc.reset_launches()
        kq.reset_launches()
        outs.append(fn(*args).cpu())
        counts.append({{**kc.launches(), **kq.launches()}})
    torch.save(outs, job["out"])
    results[job["name"]] = {{"counts": counts,
                            "steady_ms": time_ms(lambda: fn(*reqs[-1])),
                            "b1_latency_ms": latency_ms(
                                lambda: fn(*reqs[0])),
                            "meta": fn.meta}}
results["_process"] = {{
    "tf32_default": tf32, "tf32_after": torch.backends.cudnn.allow_tf32,
    "model_modules": sorted(m for m, mod in sys.modules.items()
                            if mod is not None
                            and m.startswith("codon_tpu_torch.models"))}}
print(json.dumps(results))
"""


def latency_ms(fn, n: int = 5) -> float:
    """One call's wall time on the host clock, the card synchronized
    before and after: the median of n."""
    import torch
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[n // 2]


def serve_configs(data: str, tmp: str, matrix):
    """The artifacts phase 32 serves and the live forward of each: `cli
    export` of codon bf16 with a mask input at the padded 480 x 384 (from
    x4_ship4) and of codon fp32 at 463 x 370, and the matrix's five static
    int8 artifacts. -> [{name, path, live fwd, requests, tol, export
    line}]: the requests are batches 1, 2 and 4 of the first batch of the
    scale dir (its four 463 x 370 scenes), padded with the mask for the
    masked artifact, cropped to 463 x 370 for the others."""
    import torch
    from codon_tpu_torch import export_matrix
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.core.params import BF16, FP32
    from codon_tpu_torch.models.tta import make_tta_forward
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8StaticOps

    b = first_batch(data)
    h, w = export_matrix.H, export_matrix.W
    padded = [(b.depth[:n], b.color[:n], b.mask[:n]) for n in SERVE_BATCHES]
    need(bool((b.mask[:, :h, :w] == 1).all()),
         "the first batch's scenes are not 463 x 370")
    cropped = [(b.depth[:n, :h, :w].contiguous(),
                b.color[:n, :h, :w].contiguous()) for n in SERVE_BATCHES]
    configs = []
    ship4 = params_from_numpy(load_npz(CKPT), DEVICE)
    for name, dtypes, extra, reqs, tol in (
            ("codon_bf16_mask", BF16, ["--mask", "--height",
                                       str(MAIN_SHAPE[1]), "--width",
                                       str(MAIN_SHAPE[2])], padded, 0.0),
            ("codon_fp32", FP32, ["--dtype", "fp32", "--height", str(h),
                                  "--width", str(w)], cropped,
             SERVE_FP32_TOL)):
        path = os.path.join(tmp, name + ".pt2")
        rc, said = cli_said(["export", "--ckpt", CKPT, "--out", path,
                             "--device", DEVICE, *extra])
        need(rc == 0, f"cli export {name} returned {rc}: {said}")
        v = get_variant("codon", dtypes=dtypes)
        configs.append({
            "name": name, "path": path, "requests": reqs, "tol": tol,
            "said": said.strip().splitlines()[-1],
            "fwd": (lambda d, c, m=None, v=v:
                    v.forward(ship4, d, c, mask=m))})
    for rec in matrix:
        tree = load_npz(export_matrix.best_ckpt(rec["scale"]))
        scales = params_from_numpy(tree.pop("act_scales"), DEVICE)
        params = params_from_numpy(tree, DEVICE)
        v = get_variant("codon", dtypes=BF16)
        ops = Int8StaticOps(scales, compute_dtype=torch.bfloat16)

        def base(p, d, c, m, v=v, ops=ops):
            return v.forward(p, d, c, mask=m, ops=ops)

        if rec["tta"]:
            base = make_tta_forward(base, transforms=rec["tta"])
        configs.append({
            "name": rec["artifact"][:-len(".pt2")],
            "path": os.path.join(tmp, "matrix", rec["artifact"]),
            "requests": cropped, "tol": 0.0,
            "said": f"export_matrix: {rec['size_mb']:.2f} MB in "
                    f"{rec['export_s']:.1f} s",
            "fwd": (lambda d, c, m=None, base=base, params=params:
                    base(params, d, c, m))})
    return configs


def run_serve_path(kc, kq, data: str, tmp: str):
    """The export matrix with --load-check on the card, `cli export` of
    two float artifacts, then every artifact loaded in a fresh process
    that cannot import the model code, answering batches of 1, 2 and 4
    against the live forward of the same configuration in this process
    (cuDNN deterministic in both): bitwise (the fp32 artifact, whose
    process starts with TF32 on, within SERVE_FP32_TOL), the same kernel
    launches request by request, and each one's steady b4 call and b1
    latency beside the live forward's. -> (matrix records, [row an
    artifact], process info)."""
    import torch
    from codon_tpu_torch import export_matrix

    matrix = export_matrix.run(os.path.join(tmp, "matrix"), load_check=True,
                               device=DEVICE)
    need([(r["scale"], r["tta"]) for r in matrix] == export_matrix.JOBS,
         f"the matrix exported {[r['artifact'] for r in matrix]}")
    configs = serve_configs(data, tmp, matrix)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        jobs = []
        for cfg in configs:
            outs, counts = [], []
            for args in cfg["requests"]:
                reset_counts(kc, kq)
                outs.append(cfg["fwd"](*args))
                counts.append(read_counts(kc, kq))
            cfg.update(live=outs, live_counts=counts, live_ms=time_ms(
                lambda: cfg["fwd"](*cfg["requests"][-1]), warmup=2,
                iters=5), live_b1_ms=latency_ms(
                lambda: cfg["fwd"](*cfg["requests"][0])))
            req = os.path.join(tmp, cfg["name"] + ".requests.pt")
            torch.save([[t.cpu() for t in args] for args in cfg["requests"]],
                       req)
            jobs.append({"name": cfg["name"], "path": cfg["path"],
                         "requests": req,
                         "out": os.path.join(tmp, cfg["name"] + ".out.pt")})
    finally:
        torch.backends.cudnn.deterministic = saved
    job_file = os.path.join(tmp, "serve_jobs.json")
    with open(job_file, "w") as f:
        json.dump(jobs, f)
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-c", SERVE_RUN.format(blocked=SERVE_BLOCKED,
                                                repo=REPO), job_file],
        capture_output=True, text=True, timeout=600)
    need(res.returncode == 0, f"the serving process failed "
         f"({res.returncode}):\n{res.stderr[-4000:]}")
    served = json.loads(res.stdout.strip().splitlines()[-1])
    proc = served.pop("_process")
    proc["wall_s"] = time.time() - t0
    need(not proc["model_modules"], f"the serving process imported "
         f"{proc['model_modules']}")
    rows = []
    for cfg, job in zip(configs, jobs):
        got = torch.load(job["out"])
        s = served[cfg["name"]]
        diffs = []
        for n, live, out in zip(SERVE_BATCHES, cfg["live"], got):
            need(tuple(out.shape) == tuple(live.shape)
                 and tuple(out.shape[:1]) == (n,)
                 and bool(torch.isfinite(out).all()),
                 f"{cfg['name']} b{n}: output {tuple(out.shape)}, live "
                 f"{tuple(live.shape)}")
            diffs.append(float((out - live.cpu()).abs().max()))
        need(max(diffs) <= cfg["tol"], f"{cfg['name']}: artifact vs live "
             f"max |d| {diffs} at b{SERVE_BATCHES} (bound {cfg['tol']})")
        need(s["counts"] == cfg["live_counts"], f"{cfg['name']}: launches "
             f"in the serving process {s['counts']}, live "
             f"{cfg['live_counts']}")
        rows.append({"name": cfg["name"], "said": cfg["said"],
                     "max_abs_diff": max(diffs), "tol": cfg["tol"],
                     "counts": dict(zip(SERVE_BATCHES, s["counts"])),
                     "artifact_ms": s["steady_ms"],
                     "live_ms": cfg["live_ms"],
                     "artifact_b1_ms": s["b1_latency_ms"],
                     "live_b1_ms": cfg["live_b1_ms"], "meta": s["meta"]})
    return matrix, rows, proc


# ---------------------------------------------------------------------------
# phase 33: the mesh (multi-rank inference, `codon_tpu_torch.parallel`)
# ---------------------------------------------------------------------------

# the mesh's ranks: 4 gloo ranks sharing the one card; the (dp, sp) forms
MESH_WORLD = 4
MESH_FORMS = ((1, 2), (1, 4), (2, 1), (2, 2))
# float32 sharded against single-device (TF32 off): the tolerance of
# tests/test_parallel.py, elementwise atol / rtol (a shard's convs and the
# all-reduced pools sum in another order)
MESH_FP32_TOL = (2e-4, 1e-3)
# one large frame, 4x the Middlebury scene in each axis, and JAX's bound
# on tile-and-stitch against the untiled forward (tests/test_parallel.py)
LARGE_FRAME = (1480, 1852)
STITCH_TILE = 512           # tile_stitch_infer's default tile height
STITCH_MEAN_TOL = 5e-3
MESH_TIME_ITERS = 2         # timed forwards a form (after one warm-up)
# the k > 1 quantized convs whose input is float in the static int8
# forward (conv_input(_c), conv3/conv6 x 5, conv7, conv10 x 3, conv11): on
# a shard each quantizes its rows first (a quant_im2col call at k = 1) so
# the halo rows travel as int8 codes, then gathers (a second call): the
# two kernels of one unsharded call, in two calls
INT8_FLOAT_STENCIL_CALLS = 17
# the two routes of a haloed int8 conv timed against each other: (k, C) of
# the b4 forward's sites at sp = 2 (a shard of 192 rows)
HALO_ROUTE_SITES = ((5, 128), (5, 64), (3, 128))
# the mesh cli eval against the single-device eval of the same flags, in
# uint8 PNG levels (mean, max |d|) per image. bf16: the shards and ranks
# sum in another order, which moves an output by a bf16 ulp or two, a
# level where it lies at a rounding boundary: a few pixels in a hundred at
# most, and no more than 3 levels (the H100 read 0.0013 / 1, the CPU at
# 37 x 45 0.025 / 1). int8: the static flip class of
# tests/test_torch_parallel_cli.py, 255 x 0.01 + 1 / 255 x 0.1 + 1 (the
# H100 read 0.0052 / 2)
MESH_CLI_PNG = {"bf16": (0.05, 3.0), "int8": (255 * 0.01 + 1, 255 * 0.1 + 1)}


def mesh_bf16_class(got, single, fp32, what="bf16 sharded", vs_fp32=False):
    """(mean, max |sharded - ref|, mean, max |single - fp32|) of a bf16
    forward, ref the single-device bf16 forward. The class: the sharded
    bf16 forward no farther from it, in mean, than that one is from
    float32, and in max within twice its max (sharding moves sums by an
    ulp as bf16 rounding does, and adds no error class of its own).
    vs_fp32 (the random-init zoo, whose outputs are small differences of
    large activations: a shard's bf16 partial pools, which round otherwise
    than the whole image's, make the sharded forward a bf16 forward of its
    own, as far from the single one as two bf16 forwards are): ref the
    float32 forward of the same backend, the sharded forward no farther
    from it than BF16_CLASS times the single one is, in mean, and twice
    in max."""
    d, e = (got - (fp32 if vs_fp32 else single)).abs(), (single - fp32).abs()
    r = (float(d.mean()), float(d.max()), float(e.mean()), float(e.max()))
    k = BF16_CLASS if vs_fp32 else 1.0
    need(r[0] <= k * r[2] and r[1] <= 2 * r[3],
         f"{what} vs {'fp32' if vs_fp32 else 'single'} mean {r[0]:.3e} max "
         f"{r[1]:.3e}: beyond the bf16-vs-fp32 class, mean {k} x {r[2]:.3e} "
         f"max 2 x {r[3]:.3e}")
    return r


def mesh_fp32_close(got, want, what):
    atol, rtol = MESH_FP32_TOL
    d = (got - want).abs()
    bad = int((d > atol + rtol * want.abs()).sum())
    need(bad == 0, f"{what}: {bad} values beyond atol {atol} / rtol {rtol}, "
         f"max |d| {float(d.max()):.3e}")
    return float(d.max())


def mesh_int8_launches(kq, n, h, w, static):
    """(quant_im2col, dequant_epilogue) launches of one int8 forward on a
    rank whose shard is n images of h x w: a block of images at each conv
    call, as `int8_launches`; static scales add the handoffs and the
    shard's quantize before each float-input stencil conv."""
    epi = int8_launches(kq, n, h, w)
    if not static:
        return epi, epi
    return epi + INT8_HANDOFFS + INT8_FLOAT_STENCIL_CALLS, epi


def need_mesh_counts(counts, dp, sp, cac_want, quant_want, what):
    """Every rank of the dp x sp mesh launched each CAC kernel cac_want
    times and, when quant_want is given, quant_im2col / dequant_epilogue
    those; ranks outside the mesh launched nothing."""
    for rank, c in enumerate(counts):
        inside = rank < dp * sp
        for name in ("cac_stats", "spatial_logits", "cac_apply"):
            want = cac_want if inside else 0
            need(c["cac"][name] == want, f"{what}: rank {rank} launched "
                 f"{name} {c['cac'][name]} times; expected {want}")
        if quant_want is not None:
            for name, want in zip(("quant_im2col", "dequant_epilogue"),
                                  quant_want):
                want = want if inside else 0
                need(c["quant"][name] == want, f"{what}: rank {rank} "
                     f"launched {name} {c['quant'][name]} times; expected "
                     f"{want}")


def need_cli_counts(counts, want):
    """Rank 0 of a mesh cli eval launched each CAC kernel `want` times:
    5 a forward, 2 forwards a TTA8 batch."""
    for name, count in counts.items():
        need(count == want, f"mesh cli eval: rank 0 launched {name} "
             f"{count} times; expected {want}")


def comm_text(c) -> str:
    """One rank's collective tallies: calls, bytes and transport each."""
    return ", ".join(f"{k} {v['calls']} calls {v['bytes']} B "
                     f"[{'/'.join(v['transport']) or '-'}]"
                     for k, v in c.items() if v["calls"])


def check_haloed_int8(kq, x, w8, sw, r, mask, what, **scale):
    """The haloed gather and the haloed int8 conv (the kernels through
    `codon::int8_conv`) against their plain versions on the same card
    tensors, bitwise: x (N, h + 2r, W, C) int8 codes, or float with a
    per-image `sx` as `Int8ShardedOps` gives it."""
    import torch
    k = w8.shape[0]
    need(torch.equal(kq.quant_im2col(x, k, halo=r, **scale),
                     kq.quant_im2col_plain(x, k, halo=r, **scale)),
         f"{what}: haloed quant_im2col differs from its plain version")
    got, want = (kq.int8_conv(x, w8, sw, torch.bfloat16, mask=mask,
                              impl=impl, halo=r, **scale)
                 for impl in (None, "plain"))
    need(got.shape == (x.shape[0], x.shape[1] - 2 * r, x.shape[2],
                       w8.shape[3]) and torch.equal(got, want),
         f"{what}: haloed int8_conv differs from its plain version")


def time_halo_routes(kq):
    """The two routes of a haloed int8 conv at the b4 forward's sp = 2
    shard (4 x 192 rows of 480, bfloat16 output), int8 input: (a) the
    gather reads the halo rows and writes the shard's rows only (the
    kernel's halo argument, the route the port takes); (b) a SAME gather
    over the haloed rows, the GEMM over them, and the int32 products
    cropped to the shard's rows before the epilogue. Both bitwise equal;
    each timed as device time a call (`graph_ms`, a CUDA graph of
    GRAPH_CALLS calls) and back to back with CUDA events. Before that,
    at each site, the haloed kernels against their plain versions
    (`check_haloed_int8`), with int8 input (the static sites' codes) and
    with bfloat16 input on a per-image scale (the dynamic ones'), masked
    as the shard's rows of a padded batch."""
    import torch
    n, h, w = MAIN_SHAPE[0], MAIN_SHAPE[1] // 2, MAIN_SHAPE[2]
    rows = []
    g = torch.Generator().manual_seed(33)
    mask = torch.ones(n, h, w, 1)
    mask[1:, h - 11:] = 0.0
    mask[1:, :, w - 17:] = 0.0
    mask = mask.to(DEVICE)
    for k, c in HALO_ROUTE_SITES:
        r = k // 2
        x8 = torch.randint(-127, 128, (n, h + 2 * r, w, c), generator=g,
                           dtype=torch.int8).to(DEVICE)
        w8 = torch.randint(-127, 128, (k, k, c, c), generator=g,
                           dtype=torch.int8).to(DEVICE)
        sw = (torch.rand(c, generator=g) * 1e-3).to(DEVICE)
        xf = torch.randn(n, h + 2 * r, w, c, generator=g).to(
            DEVICE, torch.bfloat16)
        # the scale as `_gathered_sample_scale` gives it, (N, 1, 1, 1)
        sx = (xf.abs().amax((1, 2, 3), keepdim=True).clamp_min(1e-8)
              / 127.0).float()
        check_haloed_int8(kq, x8, w8, sw, r, mask, f"k{k} C{c} int8 input")
        check_haloed_int8(kq, xf, w8, sw, r, mask,
                          f"k{k} C{c} bf16 input, per-image scale", sx=sx)
        wmat = w8.reshape(k * k * c, c).t().contiguous().t()

        def halo_route():
            return kq.int8_conv(x8, w8, sw, torch.bfloat16, halo=r)

        def crop_route():
            acc = kq.int8_gemm(kq.quant_im2col(x8, k), wmat)
            acc = acc.view(n, h + 2 * r, w, c)[:, r:r + h]
            return kq.dequant_epilogue(acc.reshape(-1, c).contiguous(), sw,
                                       torch.bfloat16, (n, h, w))

        a, b = halo_route(), crop_route()
        need(torch.equal(a, b), f"haloed int8 conv k{k} C{c}: the two "
             f"routes differ")
        rows.append({"k": k, "c": c,
                     "halo_device_ms": graph_ms(halo_route),
                     "crop_device_ms": graph_ms(crop_route),
                     "halo_ms": time_ms(halo_route, 2, 10),
                     "crop_ms": time_ms(crop_route, 2, 10)})
    return rows


def run_mesh_cli(kc, data: str, tmp: str, ref_out: str, ref, dtype, ckpt,
                 variant="codon", cac_per_forward=5):
    """`cli eval --tile-devices 2 --dp-devices 2 --dist-backend gloo
    --tta8 --device-metrics` (b4) against the single-device eval of the
    same flags (phase 9 or 14): each image's PNG within MESH_CLI_PNG of
    it, its RMSE within the RMS of the two PNGs' difference and SSIM within
    0.01. The mesh must have run: the cli's "mesh eval" banner, and in its
    --json summary every rank of the 2 x 2 mesh launched each CAC kernel
    5 times a forward (the quant kernels too in int8), took its blocks,
    exchanged halo rows, all-reduced its statistics and gave its outputs
    back. Rank 0's CAC counts set to 0 just before and read just after.
    variant and its CAC launches a forward (0 for the zoo) as the
    single-device eval's."""
    import contextlib
    import io

    import numpy as np
    from codon_tpu_torch.data.io import imread_gray
    out = os.path.join(tmp, f"mesh_cli_{variant.replace(':', '_')}_{dtype}")
    kc.reset_launches()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        summary, wall = eval_once(
            data, out, out + ".json", 4,
            ["--tta8", "--device-metrics", "--tile-devices", "2",
             "--dp-devices", "2", "--dist-backend", "gloo"], ckpt=ckpt,
            dtype=dtype, variant=variant)
    sys.stdout.write(said.getvalue())
    need("mesh eval: dp=2 x sp=2 over 4 devices; backend gloo (4 ranks on "
         "1 cuda device(s))" in said.getvalue(),
         f"mesh cli eval {dtype}: no mesh banner")
    counts = kc.launches()
    want = 2 * cac_per_forward * -(-len(SCENES) // 4)
    need_cli_counts(counts, want)
    report = summary["mesh"]
    need((report["dp"], report["sp"], report["backend"],
          len(report["ranks"])) == (2, 2, "gloo", MESH_WORLD),
         f"mesh cli eval {dtype}: ran on {report}")
    need_mesh_counts(report["ranks"], 2, 2, want, None,
                     f"mesh cli eval {dtype}")
    for rank, c in enumerate(report["ranks"]):
        moved = {p: c["comm"][p]["calls"] for p in
                 ("scatter", "halo_rows", "all_sum", "all_max", "gather")
                 if cac_per_forward or p != "all_max"}
        need(all(moved.values()), f"mesh cli eval {dtype}: rank {rank}'s "
             f"collectives {moved}")
        if dtype == "int8":
            need(all(c["quant"].values()), f"mesh cli eval int8: rank "
                 f"{rank}'s quant launches {c['quant']}")
    png_mean, png_max = MESH_CLI_PNG[dtype]
    worst = {"png_mean": 0.0, "png_max": 0.0, "rmse": 0.0, "ssim": 0.0}
    for m, r in zip(summary["per_image"], ref["per_image"]):
        need(m["name"] == r["name"], "the mesh eval scored other images")
        a = imread_gray(os.path.join(out, m["name"] + ".png"))
        b = imread_gray(os.path.join(ref_out, r["name"] + ".png"))
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        gap = {"png_mean": float(d.mean()), "png_max": float(d.max()),
               "rmse": abs(m["rmse"] - r["rmse"]),
               "ssim": abs(m["ssim"] - r["ssim"])}
        need(gap["png_mean"] <= png_mean and gap["png_max"] <= png_max and
             gap["rmse"] <= float(np.sqrt((d ** 2).mean())) + 1e-6 and
             gap["ssim"] <= 0.01,
             f"mesh cli eval {dtype}, {m['name']}: {gap} beyond the class "
             f"(PNG mean {png_mean}, max {png_max} levels)")
        worst = {k: max(worst[k], gap[k]) for k in worst}
    return summary, wall, counts, worst


def run_mesh_phase(kc, kq, data: str, tmp: str, refs):
    """The mesh phase: sharded forwards against the single-device ones at
    b4 and on one large frame, through 4 gloo ranks on the one card (this
    process rank 0); cli eval over a 2 x 2 mesh; NCCL's set-up. refs:
    {"bf16": (summary, out dir), "int8": (summary, out dir)} of the
    single-device TTA8 evals."""
    import dataclasses
    import functools

    import torch
    from codon_tpu_torch import quant_ops as tq
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.parallel import quant as pq
    from codon_tpu_torch.core.params import BF16
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.parallel import (MeshPool, ShardedOps, comm,
                                          make_tiled_forward,
                                          tile_stitch_infer)
    from codon_tpu_torch.parallel.launch import rank_counts, reset_rank_counts

    res = {"cli": {}, "forms": []}
    # cli eval over the mesh (its own pool, started and closed by the cli)
    for dtype, ckpt in (("bf16", CKPT), ("int8", CKPT_INT8)):
        ref, ref_out = refs[dtype]
        res["cli"][dtype] = run_mesh_cli(kc, data, tmp, ref_out, ref, dtype,
                                         ckpt)

    b = first_batch(data)
    d, c, m = b.depth, b.color, b.mask
    p = ship4_params()
    vb, vf = get_variant("codon", BF16), get_variant("codon")
    single = {"bf16": vb.forward(p, d, c, mask=m),
              "fp32": vf.forward(p, d, c, mask=m)}
    res["single_ms"] = {
        name: time_ms(lambda v=v: v.forward(p, d, c, mask=m), 1,
                      MESH_TIME_ITERS) for name, v in (("bf16", vb),
                                                       ("fp32", vf))}
    tree = load_npz(CKPT_INT8)
    scales = params_from_numpy(tree.pop("act_scales"), DEVICE)
    p8 = params_from_numpy(tree, DEVICE)
    p8d = params_from_numpy(load_npz(CKPT_INT8_DYN), DEVICE)
    bf = torch.bfloat16
    int8_single = {
        "static": vb.forward(p8, d, c, mask=m, ops=tq.Int8StaticOps(
            scales, compute_dtype=bf)),
        "dynamic": vb.forward(p8d, d, c, mask=m, ops=tq.Int8Ops())}
    res["int8_single_ms"] = {
        "static": time_ms(lambda: vb.forward(p8, d, c, mask=m,
                                             ops=tq.Int8StaticOps(
                                                 scales, compute_dtype=bf)),
                          1, MESH_TIME_ITERS),
        "dynamic": time_ms(lambda: vb.forward(p8d, d, c, mask=m,
                                              ops=tq.Int8Ops()),
                           1, MESH_TIME_ITERS)}
    n, h, w = MAIN_SHAPE[:3]
    t0 = time.time()
    with MeshPool(MESH_WORLD, device=DEVICE, backend="gloo",
                  timeout_s=300) as pool:
        res["pool_start_s"] = time.time() - t0
        res["transport"] = pool.transport

        def run(label, dp, sp, fwd, params, cac_want=5, quant_want=None):
            pool.call(reset_rank_counts)
            out = fwd(params, d, c, m)
            torch.cuda.synchronize()
            counts = pool.call(rank_counts)
            need_mesh_counts(counts, dp, sp, cac_want, quant_want, label)
            ms = time_ms(lambda: fwd(params, d, c, m), 1, MESH_TIME_ITERS)
            return out, counts, ms

        # float: bf16 and fp32 through the kernels, every form
        for dp, sp in MESH_FORMS:
            for name, v in (("bf16", vb), ("fp32", vf)):
                fwd = make_tiled_forward(v, sp, dp, pool=pool)
                out, counts, ms = run(f"{name} {dp}x{sp}", dp, sp, fwd, p)
                row = {"form": f"{dp}x{sp}", "dtype": name, "ms": ms,
                       "counts": counts}
                if name == "bf16":
                    row["class"] = mesh_bf16_class(out, single["bf16"],
                                                   single["fp32"])
                else:
                    row["max_abs_diff"] = mesh_fp32_close(
                        out, single["fp32"], f"fp32 {dp}x{sp}")
                    if (dp, sp) == (1, 4):
                        # kernel-sharded against plain-sharded
                        vt = dataclasses.replace(vf, cfg=dataclasses.replace(
                            vf.cfg, cac_impl="torch"))
                        plain = make_tiled_forward(vt, 4, 1, pool=pool)(
                            p, d, c, m)
                        row["kernel_vs_plain"] = float(
                            (out - plain).abs().max())
                        need(row["kernel_vs_plain"] <= FWD_TOL,
                             f"fp32 1x4 kernels vs plain stage "
                             f"{row['kernel_vs_plain']:.3e} > {FWD_TOL}")
                res["forms"].append(row)

        # int8: static (scales through scales_factory) and dynamic
        static = functools.partial(pq.static_int8_ops, compute_dtype=bf)
        for dp, sp in ((2, 2), (1, 4)):
            local = (n // dp, h // sp, w)
            for kind in ("static", "dynamic"):
                if kind == "static":
                    fwd = make_tiled_forward(vb, sp, dp, pool=pool,
                                             scales_factory=static)
                    params = dict(p8, act_scales=scales)
                else:
                    fwd = make_tiled_forward(vb, sp, dp, pool=pool,
                                             ops_factory=pq.Int8ShardedOps,
                                             local_ops=tq.Int8Ops())
                    params = p8d
                want = mesh_int8_launches(kq, *local, kind == "static")
                out, counts, ms = run(f"int8 {kind} {dp}x{sp}", dp, sp, fwd,
                                      params, quant_want=want)
                dd = (out - int8_single[kind]).abs()
                row = {"form": f"{dp}x{sp}", "dtype": f"int8 {kind}",
                       "ms": ms, "counts": counts,
                       "flip": (float(dd.mean()), float(dd.max()))}
                need(row["flip"][0] <= INT8_CPU_BOUNDS[0] and
                     row["flip"][1] <= INT8_CPU_BOUNDS[1],
                     f"int8 {kind} {dp}x{sp} vs unsharded: {row['flip']} "
                     f"beyond the flip class {INT8_CPU_BOUNDS}")
                res["forms"].append(row)

        # the other two forwards at sp = 2
        for name, cac_want in (("codon_fused", 5), ("rmcr_fuse_rmcr", 0)):
            v, v32 = get_variant(name, BF16), get_variant(name)
            ref, ref32 = (v.forward(p, d, c, mask=m),
                          v32.forward(p, d, c, mask=m))
            fwd = make_tiled_forward(v, 2, 1, pool=pool)
            out, counts, ms = run(f"{name} 1x2", 1, 2, fwd, p, cac_want)
            res["forms"].append({
                "form": "1x2", "dtype": f"bf16 {name}", "ms": ms,
                "counts": counts,
                "class": mesh_bf16_class(out, ref, ref32),
                "single_ms": time_ms(lambda v=v: v.forward(p, d, c, mask=m),
                                     1, MESH_TIME_ITERS)})

        # one large frame, b1 bf16: sp = 2 against untiled, and stitched
        H, W = LARGE_FRAME
        sh, sw_ = SCENES[0]
        big = [t[:1, :sh, :sw_].repeat_interleave(4, 1)
               .repeat_interleave(4, 2).contiguous() for t in (d, c)]
        ref = vb.forward(p, *big)
        ref32 = vf.forward(p, *big)
        fwd = make_tiled_forward(vb, 2, 1, pool=pool)
        pool.call(reset_rank_counts)
        out = fwd(p, *big, None)
        torch.cuda.synchronize()
        counts = pool.call(rank_counts)
        need_mesh_counts(counts, 1, 2, 5, None, "large frame 1x2")
        large = {"class": mesh_bf16_class(out, ref, ref32), "counts": counts,
                 "ms": time_ms(lambda: fwd(p, *big, None), 1, 2),
                 "single_ms": time_ms(lambda: vb.forward(p, *big), 1, 2)}
        t1 = time.time()
        stitched = tile_stitch_infer(vb, p, big[0].cpu().numpy(),
                                     big[1].cpu().numpy(), tile_h=STITCH_TILE)
        large["stitch_s"] = time.time() - t1
        large["stitch_mean"] = float(
            (torch.from_numpy(stitched).to(DEVICE) - ref).abs().mean())
        need(0 < large["stitch_mean"] < STITCH_MEAN_TOL,
             f"tile-and-stitch vs untiled mean |d| {large['stitch_mean']}")
        res["large"] = large
    need(not any(proc.is_alive() for proc in pool._procs),
         "a mesh rank outlived its pool")
    res["nccl"] = run_nccl_setup(vb, p, d, c, m, single)
    res["halo_routes"] = time_halo_routes(kq)
    return res


def run_nccl_setup(vb, p, d, c, m, single):
    """NCCL refuses 2 ranks on one card, naming gloo; its one-rank group
    runs the sharded forward (the CAC stage's all-reduces over NCCL)."""
    import torch
    from codon_tpu_torch.parallel import MeshPool, ShardedOps, comm
    res = {}
    try:
        comm.choose_backend("nccl", DEVICE, 2)
        need(torch.cuda.device_count() >= 2, "NCCL took 2 ranks on 1 card")
    except RuntimeError as e:
        need("--dist-backend gloo" in str(e), f"NCCL's refusal: {e}")
        res["refusal"] = str(e)
    with MeshPool(1, device=DEVICE, backend="nccl", timeout_s=120) as pool:
        mesh = pool.mesh(1, 1)
        comm.reset_counts()
        out = vb.forward(p, d, c, mask=m, ops=ShardedOps(mesh))
        res.update(transport=pool.transport, comm=comm.counts(),
                   **{"class": mesh_bf16_class(out, single["bf16"],
                                               single["fp32"])})
        need(res["comm"]["all_sum"]["transport"] == ["nccl"],
             "the one-rank NCCL stage did not all-reduce over NCCL")
    return res


# ---------------------------------------------------------------------------
# phase 34: sharded training (`make_train_step(..., mesh=)`)
# ---------------------------------------------------------------------------

# the step's forms over the 4 gloo ranks sharing the card, at the training
# shape (b16 p64), and one large-patch form: 4 patches of 256 x 256 over
# 1 x 4 (64-row shards), bf16
MESH_TRAIN_FORMS = ((2, 2), (1, 4), (2, 1))
MESH_TRAIN_LARGE = (4, 256, (1, 4))
# the sharded step against the single-device one, same weights and batch:
# TRAIN_TOLS' (loss rtol, the worst leaf's max |d| over its max |g|, the
# gradient tree's relative L2 distance), for the same reason: the shards'
# convs, the all-reduced pools and the gradient's sum over the ranks run
# in other float32 orders, ~1e-7 of a value, and a ReLU that flips on one
# side only moves its whole path; bf16 also no more than BF16_CLASS times
# farther from the fp32 single-device gradient than the bf16
# single-device step is
MESH_TRAIN_TOLS = TRAIN_TOLS
# the parameters after one step against the single-device step's: Adam's
# first update moves an element by about lr whatever its gradient's size,
# so where float32 leaves the gradient's sign undetermined (|g| ~ 0) the
# two may land 2 lr apart (cli train's lr 1e-4), and nowhere farther
MESH_TRAIN_PARAM_LRS = 2
# steps each form's replicas take before they are compared bitwise
MESH_TRAIN_STEPS = 3
# QAT sharded against single, relative loss: JAX's bound
# (__graft_entry__.py, tests/test_train.py)
MESH_QAT_LOSS_RTOL = 5e-3


def copy_tree(tree):
    return {k: copy_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def max_tree_diff(a, b) -> float:
    from codon_tpu_torch.train.trainer import tree_items
    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def need_mesh_train_counts(counts, dp, sp, steps, what, per_step=5):
    """Every rank of the mesh launched each CAC kernel per_step times a
    step (5, all in the forward: the backward recomputes the plain stage;
    0 for the zoo) and called the stage on shards only when sp > 1 (whole
    images when sp = 1); ranks outside the mesh did nothing."""
    for rank, c in enumerate(counts):
        inside = rank < dp * sp
        want = per_step * steps if inside else 0
        for name in ("cac_stats", "spatial_logits", "cac_apply"):
            need(c["cac"][name] == want, f"{what}: rank {rank} launched "
                 f"{name} {c['cac'][name]} times; expected {want}")
        stages = ({"whole": 0, "shard": want} if sp > 1
                  else {"whole": want, "shard": 0})
        need(c["stages"] == stages, f"{what}: rank {rank} called the CAC "
             f"stage {c['stages']}; expected {stages}")


def mesh_train_form(pool, dtype, dp, sp, params, batch, single, fp32_grads,
                    paths, ops=None, label=None, variant="codon",
                    steps=MESH_TRAIN_STEPS):
    """One form of the sharded step against the single-device one (single:
    (loss, grads, params after one step, ms a step)) -> its row. The
    gradient and the counts come from the mesh's value_and_grad (rank 0's
    summed gradient; every rank's tallies set to 0 just before, read just
    after); then MESH_TRAIN_STEPS steps from a copy of params: the first
    against the single step's parameters, the rest timed, their launches
    counted, the replicas compared. variant: a variant name (the zoo's
    launch no CAC kernel); steps: the steps before the replicas are
    compared."""
    import torch
    from codon_tpu_torch.parallel.launch import rank_counts, reset_rank_counts
    from codon_tpu_torch.parallel.train import replica_digest
    what = label or f"mesh train {dtype} {dp}x{sp}"
    per_step = 0 if variant.startswith("zoo:") else 5
    mesh = pool.mesh(dp, sp)
    step, opt = train_step_for(dtype, ops=ops, mesh=mesh, variant=variant)
    pool.call(reset_rank_counts)
    loss, grads = step.value_and_grad(params, batch)
    torch.cuda.synchronize()
    counts = pool.call(rank_counts)
    need_mesh_train_counts(counts, dp, sp, 1, what, per_step)
    l1, g1, p1, single_ms = single
    tree, worst, worst_path = grad_distance(grads, g1, paths, variant)
    row = {"form": f"{dp}x{sp}", "dtype": dtype, "loss": float(loss),
           "loss_single": float(l1),
           "loss_rel": abs(float(loss) - float(l1)) / abs(float(l1)),
           "grad_tree_rel": tree, "grad_worst_rel": worst,
           "grad_worst_leaf": worst_path, "counts": counts,
           "single_ms": single_ms}
    need(math.isfinite(row["loss"]), f"{what}: loss {row['loss']}")
    if ops is None:
        loss_tol, leaf_tol, tree_tol = MESH_TRAIN_TOLS[dtype]
        need(row["loss_rel"] <= loss_tol,
             f"{what}: loss {row['loss']} vs single {row['loss_single']}")
        need(worst <= leaf_tol and tree <= tree_tol,
             f"{what} gradients: tree {tree:.3e} (> {tree_tol}?), leaf "
             f"{worst_path} {worst:.3e} of its max |g| (> {leaf_tol}?)")
        if dtype == "bf16" and fp32_grads is not None:
            row["sharded_vs_fp32"] = grad_distance(grads, fp32_grads,
                                                   paths, variant)[0]
            row["single_vs_fp32"] = grad_distance(g1, fp32_grads, paths,
                                                  variant)[0]
            need(row["sharded_vs_fp32"]
                 <= BF16_CLASS * row["single_vs_fp32"],
                 f"{what}: {row['sharded_vs_fp32']:.3e} from the fp32 "
                 f"gradient, the single bf16 step {row['single_vs_fp32']:.3e}")
    else:
        need(row["loss_rel"] < MESH_QAT_LOSS_RTOL,
             f"{what}: loss {row['loss']} vs single {row['loss_single']} "
             f"(rel {row['loss_rel']:.2e} >= {MESH_QAT_LOSS_RTOL})")
    p = copy_tree(params)
    state = opt.init(p)
    p, state, m = step(p, state, batch)
    row["param_max_abs_diff"] = max_tree_diff(p, p1)
    bound = MESH_TRAIN_PARAM_LRS * 1e-4 + 1e-6
    need(row["param_max_abs_diff"] <= bound,
         f"{what}: params after a step max |d| {row['param_max_abs_diff']:.3e}"
         f" from the single step's (> {bound:.1e})")
    pool.call(reset_rank_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        p, state, m = step(p, state, batch)
    float(m["loss"])
    row["ms"] = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    need_mesh_train_counts(pool.call(rank_counts), dp, sp, steps - 1,
                           what + " steps", per_step)
    digests = pool.call(replica_digest, step.slot)[:mesh.size]
    need(len(set(digests)) == 1 and state["count"] == steps,
         f"{what}: the {mesh.size} replicas differ after {steps} steps")
    row["replicas"] = f"{mesh.size} bitwise equal after {steps}"
    return row


def single_train(dtype, params, batch, ops=None, variant="codon"):
    """The single-device step: (loss, grads, params after one step from a
    copy, ms a step back to back)."""
    import torch
    step, opt = train_step_for(dtype, ops=ops, variant=variant)
    loss, grads = step.value_and_grad(params, batch)
    p = copy_tree(params)
    state = opt.init(p)
    p1, state, _ = step(p, state, batch)
    p1 = copy_tree(p1)
    torch.cuda.synchronize()
    ms = time_ms(lambda: step(p, state, batch), 1, 3)
    return loss, grads, p1, ms


def run_mesh_train_phase(kc, data: str):
    """Phase 34: the sharded training step (`make_train_step(...,
    mesh=)`) over 4 gloo ranks sharing the card, each form against the
    single-device step on x4_ship4's weights and `cli train`'s batch:
    bf16 and fp32 at MESH_TRAIN_FORMS, the large-patch form, static QAT
    (x4_ship4_qat_static's act_scales) and dynamic QAT (x4_ship4_qat) at
    2 x 2; then a one-rank NCCL group's step."""
    import torch
    from codon_tpu_torch import quant_ops as tq
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.parallel import MeshPool, comm
    from codon_tpu_torch.train.trainer import tree_items
    res = {"forms": []}
    _, batch = train_batch(data)
    params = ship4_params()
    paths = [p for p, _ in tree_items(params)]
    singles = {d: single_train(d, params, batch) for d in ("fp32", "bf16")}
    fp32_grads = singles["fp32"][1]
    n, patch, (ldp, lsp) = MESH_TRAIN_LARGE
    _, big = train_batch(data, 0, patch=patch, batch=n)
    big_single = single_train("bf16", params, big)
    tree = load_npz(CKPT_INT8)
    scales = params_from_numpy(tree.pop("act_scales"), DEVICE)
    p8 = params_from_numpy(tree, DEVICE)
    p8d = params_from_numpy(load_npz(CKPT_INT8_DYN), DEVICE)
    qat = {"static": (tq.FakeQuantStaticOps(scales), p8),
           "dynamic": (tq.FakeQuantOps(), p8d)}
    qat_single = {k: single_train("bf16", p, batch, ops=o)
                  for k, (o, p) in qat.items()}
    t0 = time.time()
    with MeshPool(MESH_WORLD, device=DEVICE, backend="gloo",
                  timeout_s=300) as pool:
        res["pool_start_s"] = time.time() - t0
        for dp, sp in MESH_TRAIN_FORMS:
            for dtype in ("bf16", "fp32"):
                res["forms"].append(mesh_train_form(
                    pool, dtype, dp, sp, params, batch, singles[dtype],
                    fp32_grads, paths))
        row = mesh_train_form(pool, "bf16", ldp, lsp, params, big,
                              big_single, None, paths,
                              label=f"mesh train bf16 {ldp}x{lsp} b{n} "
                                    f"p{patch}")
        row["dtype"] = f"bf16 b{n} p{patch}"
        res["forms"].append(row)
        for kind, (o, p) in qat.items():
            row = mesh_train_form(pool, "bf16", 2, 2, p, batch,
                                  qat_single[kind], None, paths, ops=o,
                                  label=f"mesh train QAT {kind} 2x2")
            row["dtype"] = f"bf16 QAT {kind}"
            res["forms"].append(row)
    need(not any(proc.is_alive() for proc in pool._procs),
         "a mesh rank outlived its pool")
    # NCCL: one rank, its loss and gradient all-reduces over NCCL
    with MeshPool(1, device=DEVICE, backend="nccl", timeout_s=120) as pool:
        step, _ = train_step_for("bf16", mesh=pool.mesh(1, 1))
        comm.reset_counts()
        loss, grads = step.value_and_grad(params, batch)
        l1, g1 = singles["bf16"][:2]
        tree_rel, worst, _ = grad_distance(grads, g1, paths)
        res["nccl"] = {"transport": pool.transport, "comm": comm.counts(),
                       "loss_rel": abs(float(loss) - float(l1))
                       / abs(float(l1)),
                       "grad_tree_rel": tree_rel, "grad_worst_rel": worst}
        need(res["nccl"]["comm"]["all_sum"]["transport"] == ["nccl"],
             "the one-rank NCCL step did not all-reduce over NCCL")
        loss_tol, leaf_tol, tree_tol = MESH_TRAIN_TOLS["bf16"]
        need(res["nccl"]["loss_rel"] <= loss_tol and worst <= leaf_tol
             and tree_rel <= tree_tol,
             f"the one-rank NCCL step vs single: {res['nccl']}")
    return res


# ---------------------------------------------------------------------------
# phase 35: the ablation zoo over the mesh
# ---------------------------------------------------------------------------

# the zoo's sweep over the 4 gloo ranks: every net, fp32, the first two
# images of the zoo batch (463 x 370 and 450 x 375 padded to 480 x 384,
# masked) at 1 x 4, held elementwise within MESH_FP32_TOL of its
# single-device forward
ZOO_MESH_SWEEP = (2, (1, 4))
# the three nets of the bf16, int8 and training forms: CGNL's global sums,
# RCAN's pooled gate (its narrow int8 sites padded) and the CBAM towers
ZOO_MESH_NETS = ("basenet_nlar", "rmcr_fuse_rmcr_rcan", "rmcr_fuse_rmcr_eccv")
ZOO_MESH_FORMS = ((2, 2), (1, 4))
# the dynamic int8 zoo forward over the mesh, at 2 x 2, bf16 and fp32
# float parts: each held bitwise against the same sharded forward through
# the plain versions of the quant kernels (the kernels at every seam and
# padded narrow site); fp32 against the unsharded fp32 int8 forward in
# the flip class INT8_CPU_BOUNDS or, where the net's own int8 forward
# moves farther when its input moves by ZOO_INT8_PERTURB (relative), in
# that distance. INT8_CPU_BOUNDS is ~3x what trained CODONNet's int8
# forward moves under such a change; a random-init zoo net can move as
# far as its int8 forward sits from its float one (one flipped code
# cascades through the pooled gates), and a rank runs its dp block's
# batch, its convs at a shard's shape and its pools in another order
# than the whole batch's (ROADMAP C5: each of these moves it). Phase 35
# also runs the form whose pools reduce in the single-device order
# (`single_order_int8_ops`) and holds it in the flip class against the
# unsharded forward taken a dp block at a time. On a frame this small
# (ZOO_INT8_SMALL: b4, image 1 masked in its last 5 rows and 3 columns)
# sharded and unsharded held in the flip class alone. bf16: also against
# the fp32 int8 forward in `mesh_bf16_class(vs_fp32=True)`'s class.
ZOO_INT8_PERTURB = 1e-6
ZOO_INT8_SMALL = (4, 32, 24)

# the zoo's sharded steps take this many steps before the replicas are
# compared
ZOO_MESH_TRAIN_STEPS = 2
# `cli eval --variant zoo:<this> --tile-devices 2 --dp-devices 2 --tta8
# --device-metrics`, held against phase 29's single-device eval in
# MESH_CLI_PNG's bf16 class
ZOO_MESH_CLI = "rmcr_fuse_rmcr_rcan"


def _whole_image(x, mask, group):
    """This rank's rows of an (N, h, W, C) shard -> the whole image's
    (x, mask), exactly: each rank writes its rows into zeros of the
    image's height, in sp group-rank order, and the sum over the group
    adds only zeros to them."""
    import torch.distributed as dist
    from codon_tpu_torch.parallel.comm import all_sum
    n, h = x.shape[:2]
    size, rank = dist.get_world_size(group), dist.get_rank(group)

    def place(t):
        whole = t.new_zeros((n, h * size) + tuple(t.shape[2:]))
        whole[:, rank * h:(rank + 1) * h] = t
        return all_sum(whole, group)
    return place(x), None if mask is None else place(mask.to(x.dtype))


def _pool_whole_image(pool, group, x, mask=None):
    return pool(*_whole_image(x, mask, group))


def single_order_int8_ops(mesh):
    """ops_factory of a mesh rank: `parallel.quant.Int8ShardedOps` whose
    global pools gather the whole image first and then reduce it as the
    unsharded `TorchOps` does, in its order. The production backend
    all-reduces each shard's partial sums instead, in another order. This
    form tells whether that order is what sets the sharded dynamic-int8
    zoo forward apart from the unsharded one (ROADMAP C5: on the CPU it
    is not, the batch each rank runs is; the tests hold it there)."""
    import functools
    from codon_tpu_torch.core.ops import TorchOps
    from codon_tpu_torch.parallel.quant import Int8ShardedOps
    ops = Int8ShardedOps(mesh)
    for name in ("global_avg", "global_max", "global_sum"):
        setattr(ops, name, functools.partial(
            _pool_whole_image, getattr(TorchOps, name), ops.group))
    return ops


def zoo_small_frame():
    """ZOO_INT8_SMALL's frame on the card: depth, color, mask (N, H, W, 1)
    float32 from ZOO_SEED, image 1 valid on its top-left (H - 5) x
    (W - 3), zero on the padding."""
    import numpy as np
    import torch
    n, h, w = ZOO_INT8_SMALL
    rng = np.random.RandomState(ZOO_SEED)
    mask = np.ones((n, h, w, 1), np.float32)
    mask[1, h - 5:] = 0.0
    mask[1, :, w - 3:] = 0.0
    return [torch.from_numpy(a).to(DEVICE) for a in (
        rng.rand(n, h, w, 1).astype(np.float32) * mask,
        rng.rand(n, h, w, 1).astype(np.float32) * mask, mask)]


def mean_max(a, b):
    e = (a.float() - b.float()).abs()
    return (float(e.mean()), float(e.max()))


def run_zoo_mesh_phase(kc, kq, data: str, pool):
    """Phase 35: the ablation zoo over 4 gloo ranks sharing the card (this
    process rank 0), each form against its single-device forward or step:
    every net in fp32 at 1 x 4 (ZOO_MESH_SWEEP), ZOO_MESH_NETS in bf16 at
    2 x 2 and 1 x 4 (`mesh_bf16_class(vs_fp32=True)`), in dynamic int8 at
    2 x 2, bf16 and fp32 (each bitwise its plain-quant twin, every rank's
    quant launches those of its shard; fp32 against the unsharded int8
    forward, on the zoo batch and on ZOO_INT8_SMALL's frame, as
    ZOO_INT8_PERTURB's note says), and in sharded training at 2 x 2 (b16
    p64, bf16 and fp32, TRAIN_TOLS, params within 2 lr, replicas bitwise
    after ZOO_MESH_TRAIN_STEPS steps). No rank launches a CAC kernel or
    calls the CAC stage."""
    import functools

    import torch
    from codon_tpu_torch import quant_ops as tq
    from codon_tpu_torch.core.params import BF16
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.models.zoo import list_zoo
    from codon_tpu_torch.parallel import make_tiled_forward
    from codon_tpu_torch.parallel import quant as pq
    from codon_tpu_torch.parallel.launch import rank_counts, reset_rank_counts
    from codon_tpu_torch.train.trainer import tree_items
    res = {"sweep": [], "forms": [], "train": []}
    b = zoo_batch(data)
    d, c, m = b.depth, b.color, b.mask
    small = zoo_small_frame()

    def run(label, dp, sp, fwd, params, dd, cc, mm, quant_want=None,
            timed=True):
        pool.call(reset_rank_counts)
        out = fwd(params, dd, cc, mm)
        torch.cuda.synchronize()
        counts = pool.call(rank_counts)
        need_mesh_counts(counts, dp, sp, 0, quant_want, label)
        for rank, cnt in enumerate(counts):
            need(cnt["stages"] == {"whole": 0, "shard": 0},
                 f"{label}: rank {rank} called the CAC stage "
                 f"{cnt['stages']}")
        ms = (time_ms(lambda: fwd(params, dd, cc, mm), 1, MESH_TIME_ITERS)
              if timed else None)
        return out, counts, ms

    n2, (dp, sp) = ZOO_MESH_SWEEP
    d2, c2, m2 = d[:n2], c[:n2], m[:n2]
    for name in list_zoo():
        v = get_variant("zoo:" + name)
        p = zoo_params(name)
        single = v.forward(p, d2, c2, mask=m2)
        fwd = make_tiled_forward(v, sp, dp, pool=pool)
        out, counts, ms = run(f"zoo {name} fp32 {dp}x{sp}", dp, sp, fwd, p,
                              d2, c2, m2)
        res["sweep"].append({
            "name": name, "ms": ms, "counts": counts,
            "max_abs_diff": mesh_fp32_close(
                out, single, f"zoo {name} fp32 {dp}x{sp}"),
            "max_abs_y": float(single.abs().max())})
        del p
    for name in ZOO_MESH_NETS:
        vb, vf = get_variant("zoo:" + name, BF16), get_variant("zoo:" + name)
        p = zoo_params(name)
        single = {"bf16": vb.forward(p, d, c, mask=m),
                  "fp32": vf.forward(p, d, c, mask=m),
                  "int8": vb.forward(p, d, c, mask=m, ops=tq.Int8Ops()),
                  "int8_fp32": vf.forward(p, d, c, mask=m,
                                          ops=tq.Int8Ops())}
        single_ms = time_ms(lambda: vb.forward(p, d, c, mask=m), 1,
                            MESH_TIME_ITERS)
        for fdp, fsp in ZOO_MESH_FORMS:
            fwd = make_tiled_forward(vb, fsp, fdp, pool=pool)
            out, counts, ms = run(f"zoo {name} bf16 {fdp}x{fsp}", fdp, fsp,
                                  fwd, p, d, c, m)
            res["forms"].append({
                "name": name, "dtype": "bf16", "form": f"{fdp}x{fsp}",
                "ms": ms, "single_ms": single_ms, "counts": counts,
                "fp32_class": mesh_bf16_class(
                    out, single["bf16"], single["fp32"],
                    f"zoo {name} bf16 {fdp}x{fsp}", vs_fp32=True)})
        calls = zoo_int8_calls(name)
        local = (MAIN_SHAPE[0] // 2, MAIN_SHAPE[1] // 2, MAIN_SHAPE[2])
        want = zoo_int8_launches(kq, calls, *local)
        eps = 1 + ZOO_INT8_PERTURB
        perturbed = mean_max(vf.forward(p, d * eps, c * eps, mask=m,
                                        ops=tq.Int8Ops()),
                             single["int8_fp32"])
        plain = functools.partial(pq.Int8ShardedOps, quant_impl="plain")
        for dtype, v in (("bf16", vb), ("fp32", vf)):
            label = f"zoo {name} int8 {dtype} 2x2"
            out, counts, ms = run(
                label, 2, 2, make_tiled_forward(
                    v, 2, 2, pool=pool, ops_factory=pq.Int8ShardedOps),
                p, d, c, m, quant_want=(want["quant_im2col"],
                                        want["dequant_epilogue"]))
            twin, _, _ = run(f"{label}, plain quant", 2, 2,
                             make_tiled_forward(v, 2, 2, pool=pool,
                                                ops_factory=plain),
                             p, d, c, m, quant_want=(0, 0), timed=False)
            need(torch.equal(out, twin), f"{label}: through the quant "
                 f"kernels, {mean_max(out, twin)} from the plain versions")
            row = {"name": name, "dtype": f"int8 dynamic {dtype}",
                   "form": "2x2", "ms": ms, "counts": counts}
            if dtype == "bf16":
                row["vs_single"] = mean_max(out, single["int8"])
                row["fp32_class"] = mesh_bf16_class(
                    out, single["int8"], single["int8_fp32"], label,
                    vs_fp32=True)
            else:
                row["vs_single"] = mean_max(out, single["int8_fp32"])
                row["perturbed"] = perturbed
                bound = [max(a, b) for a, b in zip(INT8_CPU_BOUNDS,
                                                    perturbed)]
                need(all(x <= y for x, y in zip(row["vs_single"], bound)),
                     f"{label} vs unsharded: {row['vs_single']}, beyond "
                     f"the flip class {INT8_CPU_BOUNDS} and the unsharded "
                     f"forward's own move {perturbed} under x {eps}")
                sd, sc, sm = small
                row["small"] = mean_max(
                    make_tiled_forward(vf, 2, 2, pool=pool,
                                       ops_factory=pq.Int8ShardedOps)(
                        p, sd, sc, sm),
                    vf.forward(p, sd, sc, mask=sm, ops=tq.Int8Ops()))
                need(all(x <= y for x, y in zip(row["small"],
                                                INT8_CPU_BOUNDS)),
                     f"{label} on the b{ZOO_INT8_SMALL[0]} "
                     f"{ZOO_INT8_SMALL[1]}x{ZOO_INT8_SMALL[2]} frame vs "
                     f"unsharded: {row['small']}, beyond the flip class "
                     f"{INT8_CPU_BOUNDS}")
                # C5's witnesses, measured: the unsharded forward taken a dp
                # block at a time, and the single-order pools' form
                half = d.shape[0] // 2
                blocks = torch.cat([vf.forward(
                    p, d[i:i + half], c[i:i + half], mask=m[i:i + half],
                    ops=tq.Int8Ops()) for i in (0, half)])
                so, _, _ = run(f"{label}, single-order pools", 2, 2,
                               make_tiled_forward(
                                   vf, 2, 2, pool=pool,
                                   ops_factory=single_order_int8_ops),
                               p, d, c, m, timed=False)
                row["c5"] = {"vs_blocks": mean_max(out, blocks),
                             "single_order_vs_production": mean_max(so, out),
                             "single_order_vs_single": mean_max(
                                 so, single["int8_fp32"]),
                             "single_order_vs_blocks": mean_max(so, blocks)}
                need(all(x <= y for x, y in zip(
                    row["c5"]["single_order_vs_blocks"], INT8_CPU_BOUNDS)),
                     f"{label}, single-order pools, vs the unsharded "
                     f"forward a dp block at a time: "
                     f"{row['c5']['single_order_vs_blocks']}, beyond the "
                     f"flip class {INT8_CPU_BOUNDS}")
            res["forms"].append(row)
        del p, single
    # sharded training at 2 x 2 against the single-device step
    _, batch = train_batch(data)
    for name in ZOO_MESH_NETS:
        variant = "zoo:" + name
        params = zoo_params(name)
        paths = [q for q, _ in tree_items(params)]
        singles = {dt: single_train(dt, params, batch, variant=variant)
                   for dt in ("fp32", "bf16")}
        for dtype in ("bf16", "fp32"):
            row = mesh_train_form(
                pool, dtype, 2, 2, params, batch, singles[dtype],
                singles["fp32"][1], paths, variant=variant,
                label=f"zoo {name} train {dtype} 2x2",
                steps=ZOO_MESH_TRAIN_STEPS)
            row["name"] = name
            res["train"].append(row)
        del params, singles
    return res


def run_zoo_mesh_cli(kc, data: str, tmp: str, zev):
    """Phase 35's `cli eval --variant zoo:ZOO_MESH_CLI --tile-devices 2
    --dp-devices 2 --tta8 --device-metrics` (bf16, its own pool) against
    phase 29's single-device eval of the same flags (zev)."""
    ref = zev[ZOO_MESH_CLI][0]
    ref_out = os.path.join(tmp, f"zoo_{ZOO_MESH_CLI}")
    return run_mesh_cli(kc, data, tmp, ref_out, ref, "bf16", None,
                        variant="zoo:" + ZOO_MESH_CLI, cac_per_forward=0)


# ---------------------------------------------------------------------------
# phase 36: codon_fused training (the CAC kernels on the halves of T)
# ---------------------------------------------------------------------------

FUSED_TRAIN_STEPS = 3


def run_fused_train_phase(kc, data: str, tmp: str, pool):
    """Phase 36: codon_fused's training step against its plain-stage step
    (TRAIN_TOLS, fp32 and bf16) and, fp32, against codon's step on the
    same weights (the same net: TRAIN_TOLS' fp32 bounds), with 5 launches
    of each CAC kernel a step, all in the forward; both steps timed from
    CUDA events over TIME_ITERS steps; `cli train --variant codon_fused`
    from x4_ship4 (bf16 and fp32, FUSED_TRAIN_STEPS steps) with the
    counts; one sharded bf16 step at 2 x 2 against its single step."""
    import torch
    from codon_tpu_torch.train.trainer import tree_items
    params = ship4_params()
    _, batch = train_batch(data)
    paths = [p for p, _ in tree_items(params)]
    res = {"grads": [], "time": {}, "cli": {}}
    ref = {}
    for dtype in ("fp32", "bf16"):
        out = {}
        for variant, impl in (("codon_fused", None),
                              ("codon_fused", "torch"), ("codon", None)):
            step, _ = train_step_for(dtype, cac_impl=impl, variant=variant)
            kc.reset_launches()
            out[variant, impl] = step.value_and_grad(params, batch)
            torch.cuda.synchronize()
            got = kc.launches()
            want = 0 if impl == "torch" else 5
            need(got == {k: want for k in got}, f"{variant} {dtype} "
                 f"cac_impl={impl} step launched {got}; expected {want} of "
                 f"each, in the forward")
        lk, gk = out["codon_fused", None]
        row = {"dtype": dtype, "loss": float(lk)}
        loss_tol, leaf_tol, tree_tol = TRAIN_TOLS[dtype]
        for key, tag in ((("codon_fused", "torch"), "plain"),
                         (("codon", None), "codon")):
            if tag == "codon" and dtype != "fp32":
                continue
            lt, gt = out[key]
            tree, worst, leaf = grad_distance(gk, gt, paths)
            rel = abs(float(lk) - float(lt)) / abs(float(lt))
            need(math.isfinite(float(lk)) and rel <= loss_tol and
                 worst <= leaf_tol and tree <= tree_tol,
                 f"codon_fused {dtype} vs {tag}: loss rel {rel:.2e}, tree "
                 f"{tree:.3e}, leaf {leaf} {worst:.3e} beyond "
                 f"{TRAIN_TOLS[dtype]}")
            row[tag] = {"loss": float(lt), "loss_rel": rel, "grad_tree_rel":
                        tree, "grad_worst_rel": worst,
                        "grad_worst_leaf": leaf}
        if dtype == "fp32":
            ref = out["codon_fused", "torch"][1]
        else:
            row["kernels_vs_fp32"] = grad_distance(gk, ref, paths)[0]
            row["plain_vs_fp32"] = grad_distance(
                out["codon_fused", "torch"][1], ref, paths)[0]
            need(row["kernels_vs_fp32"] <= BF16_CLASS * row["plain_vs_fp32"],
                 f"codon_fused bf16 kernel step {row['kernels_vs_fp32']:.3e} "
                 f"from the fp32 gradient, plain {row['plain_vs_fp32']:.3e}")
        res["grads"].append(row)
        for variant in ("codon_fused", "codon"):
            step, opt = train_step_for(dtype, variant=variant)
            p = copy_tree(params)
            state = opt.init(p)
            res["time"][dtype, variant] = time_ms(
                lambda: step(p, state, batch), 2, TIME_ITERS)
        del out
    for dtype in ("bf16", "fp32"):
        ck = os.path.join(tmp, f"fused_train_{dtype}.npz")
        said, counts, wall = train_cli(kc, [
            "--data-dir", data, "--variant", "codon_fused", "--dtype", dtype,
            "--ckpt-in", CKPT, "--steps", str(FUSED_TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--patch", str(TRAIN_PATCH),
            "--log-every", "1", "--ckpt-out", ck])
        need_train_counts(counts, FUSED_TRAIN_STEPS,
                          f"cli train --variant codon_fused {dtype}")
        res["cli"][dtype] = {"losses": train_losses(said), "wall_s": wall,
                             "counts": counts}
    single = single_train("bf16", params, batch, variant="codon_fused")
    row = mesh_train_form(pool, "bf16", 2, 2, params, batch, single, None,
                          paths, variant="codon_fused",
                          label="mesh train codon_fused bf16 2x2")
    row["dtype"] = "bf16 codon_fused"
    res["mesh"] = row
    return res


# ---------------------------------------------------------------------------
# phase 37: the tools (soup, sc_cond_probe) and the pyramid sampler
# ---------------------------------------------------------------------------

CKPT_SC = os.path.join(REPO, "checkpoints", "x4_holdout_sc.npz")
PYRAMID = (0.5, 0.75)


def run_tools_phase(kc, data: str, tmp: str):
    """Phase 37: `python -m codon_tpu_torch.soup` of x4_ship4 and
    x4_holdout2 (in-process) and a bf16 `cli eval` of the soup (finite
    metrics, 10 CAC launches each); `sc_cond_probe` on three scenes of the
    scale dir with x4_holdout_sc (3 rows of finite RMSEs and deltas, the
    --json file holding the printed rows); a PatchSampler with
    pyramid=PYRAMID over the scale dir's scenes (its levels' build ms)
    and one bf16 training step on a batch it draws."""
    import contextlib
    import io
    import numpy as np
    import torch
    from codon_tpu_torch import sc_cond_probe, soup
    from codon_tpu_torch.data.io import discover_pairs, imread_gray
    from codon_tpu_torch.data.pipeline import to_device
    from codon_tpu_torch.train.data import PatchSampler
    res = {}
    out = os.path.join(tmp, "soup.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        need(soup.main([out, CKPT, CKPT2]) == 0, "soup failed")
    res["soup_said"] = buf.getvalue().strip()
    kc.reset_launches()
    eout = os.path.join(tmp, "soup_eval")
    summary, wall = eval_once(data, eout, eout + ".json", 4, ckpt=out)
    counts = kc.launches()
    need(all(math.isfinite(summary[k]) for k in ("mean_rmse", "mean_ssim"))
         and len(summary["per_image"]) == len(SCENES),
         "the soup's eval did not score every image")
    want = 5 * -(-len(SCENES) // 4)
    need(counts == {k: want for k in counts}, f"the soup's eval launched "
         f"{counts}")
    res["soup_eval"] = {"mean_rmse": summary["mean_rmse"],
                        "mean_ssim": summary["mean_ssim"], "wall_s": wall,
                        "counts": counts}
    names = discover_pairs(data)[:3]
    jpath = os.path.join(tmp, "sc_probe.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sc_cond_probe.main(["--data-dir", data, "--ckpt", CKPT_SC,
                                 "--scenes", ",".join(names), "--json",
                                 jpath])
    need(rc == 0, "sc_cond_probe failed")
    rows = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
    with open(jpath) as f:
        written = json.load(f)
    need(len(rows) == 3 and written["rows"] == rows and all(
        math.isfinite(x) for r in rows for k in ("rmse_by_cond",
                                                 "mean_abs_delta")
        for x in r[k].values()), f"sc_cond_probe rows {rows}")
    res["sc_rows"] = rows
    imgs = {sub: [imread_gray(os.path.join(data, sub, n + ".png"))
                  for n in discover_pairs(data)]
            for sub in ("input_label", "input_color", "input_depth")}
    t0 = time.perf_counter()
    sampler = PatchSampler(imgs["input_label"], imgs["input_color"], scale=4,
                           patch=TRAIN_PATCH, batch=TRAIN_BATCH,
                           degraded=imgs["input_depth"], pyramid=PYRAMID)
    res["pyramid_build_ms"] = (time.perf_counter() - t0) * 1e3
    need(len(sampler._levels) == 1 + len(PYRAMID),
         f"the pyramid sampler built {len(sampler._levels)} levels")
    res["pyramid_sizes"] = [list(lv[0][0].shape) for lv in sampler._levels]
    t0 = time.perf_counter()
    host = sampler.sample_at(0)
    res["pyramid_sample_ms"] = (time.perf_counter() - t0) * 1e3
    batch = {k: to_device(v, torch.device(DEVICE)) for k, v in host.items()}
    step, opt = train_step_for("bf16")
    p = ship4_params()
    kc.reset_launches()
    p, _, metrics = step(p, opt.init(p), batch)
    res["pyramid_step"] = {"loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "counts": kc.launches()}
    need(math.isfinite(res["pyramid_step"]["loss"]) and
         res["pyramid_step"]["counts"] == {k: 5 for k in counts},
         f"the pyramid batch's step: {res['pyramid_step']}")
    need(bool(np.isfinite(host["depth"]).all()), "a non-finite patch")
    return res


# ---------------------------------------------------------------------------
# phase 38: entry() and the last two model scripts
# ---------------------------------------------------------------------------

# ttt_probe on the card: this many scenes of the scale dir, steps and
# warmup steps of fine-tuning each (the script's lr, patch and batch)
TTT_SCENES, TTT_STEPS, TTT_WARMUP = 3, 20, 5
# the JAX scripts' own JSON, whose keys the port's must repeat
SHIFT_JSON = os.path.join(REPO, "checkpoints", "shift_probe_x4_holdout2.json")
TTT_JSON = os.path.join(REPO, "checkpoints", "ttt_probe_x4_gentle.json")


def json_keys(path: str, rows: str) -> tuple:
    """-> (a JSON file's top-level keys, its first row's)."""
    with open(path) as f:
        d = json.load(f)
    return list(d), list(d[rows][0])


def run_probes_phase(kc, data: str, tmp: str):
    """Phase 38: `entry()`'s bf16 forward (finite, 1 x 370 x 463 x 1, 5
    launches of each CAC kernel); `tta_shift_probe.main` with x4_holdout2
    over the scale dir (finite rows, the JAX script's JSON keys, 5 launches
    each a batched TTA4 forward: 5 shifts x the batches); `ttt_probe.main
    --tta` over TTT_SCENES scenes (finite rows, the JAX script's keys;
    launches 5 each a scoring forward and a training step, none in a
    backward), and its second scene alone, whose rmse_before must equal
    the first run's (each scene starts from the checkpoint)."""
    import contextlib
    import io
    import torch
    from codon_tpu_torch import entry as tentry
    from codon_tpu_torch import tta_shift_probe, ttt_probe
    from codon_tpu_torch.data.io import discover_pairs
    res = {}
    fn, example = tentry.entry()
    kc.reset_launches()
    t0 = time.perf_counter()
    out = fn(*example)
    torch.cuda.synchronize()
    res["entry"] = {"ms": (time.perf_counter() - t0) * 1e3,
                    "shape": tuple(out.shape), "dtype": str(out.dtype),
                    "finite": bool(torch.isfinite(out).all()),
                    "counts": kc.launches()}
    need(res["entry"]["shape"] == tentry.EXAMPLE_SHAPE
         and res["entry"]["finite"]
         and res["entry"]["counts"] == {k: 5 for k in res["entry"]["counts"]},
         f"entry(): {res['entry']}")
    del fn, example, out

    def run(module, args):
        kc.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = module.main(args)
        torch.cuda.synchronize()
        need(rc == 0, f"{module.__name__} exited {rc}")
        return kc.launches(), time.perf_counter() - t0

    root = os.path.dirname(data)
    jpath = os.path.join(tmp, "shift_probe.json")
    counts, wall = run(tta_shift_probe, ["--data-root", root, "--ckpt",
                                         CKPT2, "--json", jpath])
    with open(jpath) as f:
        shift = json.load(f)
    want = 5 * len(tta_shift_probe.SHIFTS) * -(-len(SCENES) // 4)
    need(json_keys(jpath, "per_image") == json_keys(SHIFT_JSON, "per_image")
         and len(shift["per_image"]) == len(SCENES)
         and all(math.isfinite(v) for r in shift["per_image"]
                 for k, v in r.items() if k != "name"),
         f"tta_shift_probe wrote {shift}")
    need(counts == {k: want for k in counts},
         f"tta_shift_probe launched {counts}; expected {want} each")
    res["shift"] = {"json": shift, "counts": counts, "wall_s": wall}
    names = discover_pairs(data)[:TTT_SCENES]
    args = ["--data-root", root, "--ckpt", CKPT2, "--steps",
            str(TTT_STEPS), "--warmup", str(TTT_WARMUP), "--tta"]
    jpath = os.path.join(tmp, "ttt_probe.json")
    counts, wall = run(ttt_probe, args + ["--images", ",".join(names),
                                          "--json", jpath])
    with open(jpath) as f:
        ttt = json.load(f)
    want = 5 * (TTT_STEPS + 2) * len(names)
    need(json_keys(jpath, "results") == json_keys(TTT_JSON, "results")
         and [r["name"] for r in ttt["results"]] == names
         and all(math.isfinite(v) for r in ttt["results"]
                 for k, v in r.items() if k != "name"),
         f"ttt_probe wrote {ttt}")
    need(counts == {k: want for k in counts},
         f"ttt_probe launched {counts}; expected {want} each (5 a scoring "
         f"forward, 5 a step's forward, none in a backward)")
    res["ttt"] = {"json": ttt, "counts": counts, "wall_s": wall}
    jpath = os.path.join(tmp, "ttt_alone.json")
    counts, wall = run(ttt_probe, args + ["--images", names[1],
                                          "--json", jpath])
    with open(jpath) as f:
        alone = json.load(f)["results"][0]
    res["ttt_alone"] = {"row": alone, "counts": counts, "wall_s": wall}
    need(alone["rmse_before"] == ttt["results"][1]["rmse_before"],
         f"ttt_probe: {names[1]} scored {alone['rmse_before']} alone, "
         f"{ttt['results'][1]['rmse_before']} after {names[0]}'s "
         f"fine-tuning: a scene did not start from the checkpoint")
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "codon_tpu_torch")):
        print("chip_smoke: codon_tpu_torch/ not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from codon_tpu_torch import perf_copy_probe as probe
    from codon_tpu_torch.kernels import _build
    from codon_tpu_torch.kernels import cac as kc
    from codon_tpu_torch.kernels import copy as kcopy
    from codon_tpu_torch.kernels import quant as kq

    # 1. the card
    card = card_line()
    kind_name = torch.cuda.get_device_name(0)
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    # 2. build
    path, build_s = _build.build()
    _build.load()
    say(f"build: {os.path.basename(path)}: "
        + (f"nvcc {build_s:.1f} s" if build_s else "already built"))
    usage = _build.ptxas_usage(path)
    need(bool(usage), "the build left no ptxas report")
    say("ptxas: " + ptxas_text(usage, kcopy.RING_BYTES))

    # 3. kernels against their plain versions
    t0 = time.time()
    checks = check_kernels(kc)
    for name, rows in checks.items():
        for r in rows:
            say(f"check {name} {r['dtype']} {tuple(r['shape'])}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + (f" bitwise {r['bitwise']}" if "bitwise" in r else "")
                + f": max_abs_err {r['max_abs_err']:.3e} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in checks.items() for r in rows if not r["ok"]]
    need(not bad, f"{len(bad)} kernel checks out of tolerance: {bad}")
    timings = time_kernels(kc)
    for name, t in timings.items():
        say(f"time {name} {tuple(MAIN_SHAPE)}: wrapper {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms"
            + (f", library {t['library_ms']:.4f} ms"
               if t["library_ms"] is not None else ""))
        for r in t["by_shape"]:
            say(f"device {name} {tuple(r['shape'])}: "
                f"{r['device_ms'] * 1e3:.2f} us a launch ({GRAPH_CALLS} "
                f"calls in a CUDA graph); bound {r['bound_ms'] * 1e3:.2f} us "
                f"by {r['bound_by']} ({r['share_of_bound']:.1%} of it)"
                + (f", fp32 instruction floor {r['insn_floor_ms'] * 1e3:.2f} "
                   f"us" if "insn_floor_ms" in r else "")
                + (f"; library {r['library_device_ms'] * 1e3:.2f} us a "
                   f"call in a graph, {r['library_ms'] * 1e3:.2f} us back to "
                   f"back" if r["library_ms"] is not None else ""))
    for r in timings["spatial_logits"]["small"]:
        say(f"device spatial_logits {tuple(r['shape'])}: "
            f"{r['device_ms'] * 1e3:.2f} us a launch")
    # 3, the merged-tower layout: cac_stats and cac_apply on the halves of
    # one (N, H, W, 2C) tensor
    pchecks = check_pitched_kernels(kc)
    for name, rows in pchecks.items():
        for r in rows:
            say(f"check {name} pitch {r['pitch']} {r['dtype']} "
                f"{tuple(r['shape'])}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + f": max_abs_err {r['max_abs_err']:.3e} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in pchecks.items() for r in rows
           if not r["ok"]]
    need(not bad, f"{len(bad)} pitched kernel checks out of tolerance: "
         f"{bad}")
    rchecks = check_stats_repeats(kc)
    for r in rchecks:
        say(f"check cac_stats repeat bfloat16 {tuple(r['shape'])} "
            f"mask=True: 2 eager calls bitwise {r['eager']}, a CUDA graph "
            f"of a call replayed twice bitwise with them {r['graph']}, "
            f"{r['launches_2_calls']} launches for 2 calls "
            f"{'ok' if r['ok'] else 'FAIL'}")
    need(all(r["ok"] for r in rchecks),
         f"cac_stats repeats: {[r for r in rchecks if not r['ok']]}")
    ptimes = time_pitched_kernels(kc, timings)
    for name, rows in ptimes.items():
        for r in rows:
            say(f"device {name} pitch {r['pitch']} {tuple(r['shape'])}: "
                f"{r['device_ms'] * 1e3:.2f} us a launch, contiguous "
                f"{r['contiguous_device_ms'] * 1e3:.2f} us; bound "
                f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}")
    say(f"kernel checks and timings: {time.time() - t0:.1f} s")

    # 3, the int8 conv's kernels: bitwise against their plain versions,
    # then timed at the int8 forward's shapes
    t0 = time.time()
    qchecks = check_quant_kernels(kq)
    for name, rows in qchecks.items():
        for r in rows:
            say(f"check {name} {r['dtype']} {tuple(r['shape'])} "
                + (f"k={r['k']} " if "k" in r else "")
                + f"{r['mode']}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + f" bitwise {r['bitwise']}: max_abs_err "
                  f"{r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in qchecks.items() for r in rows if not r["ok"]]
    need(not bad, f"{len(bad)} quant kernel checks not bitwise: {bad}")
    qtimes, gemms = time_quant(kq)
    for name, t in qtimes.items():
        say(f"time {name} {tuple(t['shape'])}: wrapper {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']}")
        for r in t["by_shape"]:
            say(f"device {name} {tuple(r['shape'])}"
                + (f" k={r['k']} {r['input']}" if "k" in r else "")
                + f": {r['device_ms'] * 1e3:.2f} us a launch ({GRAPH_CALLS} "
                  f"calls in a CUDA graph); bound {r['bound_ms'] * 1e3:.2f} "
                  f"us by {r['bound_by']}; {r['calls_a_forward']} launches a "
                  f"b4 forward")
        say(f"device {name}, a b4 int8 forward: {t['device_ms_a_forward']:.4f}"
            f" ms over its launches; bound {t['bound_ms_a_forward']:.4f} ms")
    for r in gemms:
        say(f"gemm torch._int_mm ({r['m']} x {r['k']}) x ({r['k']} x "
            f"{r['n']}): {r['ms']:.4f} ms back to back; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}; "
            f"{r['calls_a_forward']} calls a b4 forward")
    gemm_ms = sum(r["ms"] * r["calls_a_forward"] for r in gemms)
    gemm_bound = sum(r["bound_ms"] * r["calls_a_forward"] for r in gemms)
    say(f"gemm, a b4 int8 forward: {gemm_ms:.4f} ms over its calls; bound "
        f"{gemm_bound:.4f} ms")
    # 3, the grouped int8 convs of codon_fused: channel and output windows
    wchecks = check_windowed_quant_kernels(kq)
    for name, rows in wchecks.items():
        for r in rows:
            say(f"check {name} window {r['window']} {r['dtype']} "
                f"{tuple(r['shape'])} "
                + (f"k={r['k']} " if "k" in r else "")
                + f"{r['mode']} bitwise {r['bitwise']}: max_abs_err "
                  f"{r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in wchecks.items() for r in rows
           if not r["ok"]]
    need(not bad, f"{len(bad)} windowed quant checks not bitwise: {bad}")
    wtimes = time_windowed_quant(kq)
    for r in wtimes:
        say(f"device grouped site k={r['k']} C={r['c_in']}->{r['c_out']} "
            f"x{r['groups']} {tuple(r['shape'])}: gather of a window "
            f"{r['gather_device_ms'] * 1e3:.2f} us (contiguous "
            f"{r['gather_contiguous_device_ms'] * 1e3:.2f}, bound "
            f"{r['gather_bound_ms'] * 1e3:.2f}); quantize all C "
            f"{r['quantize_device_ms'] * 1e3:.2f} us (bound "
            f"{r['quantize_bound_ms'] * 1e3:.2f}); epilogue into a window "
            f"{r['epilogue_device_ms'] * 1e3:.2f} us (contiguous "
            f"{r['epilogue_contiguous_device_ms'] * 1e3:.2f}, bound "
            f"{r['epilogue_bound_ms'] * 1e3:.2f}); launches a b4 forward "
            f"{r['launches_a_forward']}")
    say(f"quant kernel checks and timings: {time.time() - t0:.1f} s")

    # 4. the main path
    with tempfile.TemporaryDirectory(prefix="codon_chip_smoke_") as tmp:
        summary, warm, counts, wall, data = run_main_path(kc, tmp)
        say(f"main path: cli eval bf16 b4, {summary['images']} images, "
            f"mean RMSE {summary['mean_rmse']}, mean SSIM "
            f"{summary['mean_ssim']}, {wall:.1f} s wall; img/s steady "
            f"{summary['img_per_sec_steady']}, end-to-end "
            f"{summary['img_per_sec_e2e']}; launches {counts}")
        same = all(warm[k] == summary[k] for k in ("mean_rmse", "mean_ssim"))
        say(f"main path again, warm: img/s steady "
            f"{warm['img_per_sec_steady']}, compute+D2H "
            f"{warm['img_per_sec_compute']}, end-to-end "
            f"{warm['img_per_sec_e2e']}; same scores as the first run: "
            f"{same}")

        # 5. paths against each other
        d_paths, d_cpu = compare_paths(data)
        say(f"fp32 forward b4 384x480: kernels vs plain stage max abs diff "
            f"{d_paths:.3e} (<= {FWD_TOL}); card vs CPU 37x29 {d_cpu:.3e} "
            f"(<= {CPU_TOL})")

        # 6. the copy kernels against their plain version, the identity
        t0 = time.time()
        copy_checks = check_copies(kcopy, probe)
        for r in copy_checks:
            say(f"check {r['name']} tile {r['tile']} {tuple(r['shape'])} "
                f"({layout_text(r)}): bitwise {r['bitwise']}, sentinel "
                f"intact {r['guard']} {'ok' if r['ok'] else 'FAIL'}")
        bad = [r for r in copy_checks if not r["ok"]]
        need(not bad, f"{len(bad)} copy checks failed: {bad}")

        # 7. the copy kernels' times at the probe's shape
        copy_times = time_copies(kcopy, probe)
        for name, t in copy_times.items():
            for r in t["by_tile"]:
                say(f"copy {name} tile {r['tile']} ({layout_text(r)}): "
                    f"{r['ms']:.4f} ms {r['gb_per_s']:.0f} GB/s, "
                    f"{r['of_clone']:.1%} of clone(); bound "
                    f"{t['bound_ms']:.4f} ms by bytes "
                    f"({t['bound_ms'] / r['ms']:.1%} of it)")
            say(f"copy {name}: plain {t['plain_ms']:.4f} ms; clone() "
                f"{t['library_ms']:.4f} ms")
        say(f"copy checks and timings: {time.time() - t0:.1f} s")

        # 8. the probe's sweep: the copy kernels' path
        sweep, copy_counts = run_probe(kcopy, probe)
        ceiling = max(r["gb_per_s"] for r in sweep)
        best = max(sweep, key=lambda r: r["gb_per_s"])
        say(f"copy probe: launches {copy_counts}; measured copy ceiling "
            f"{ceiling:.0f} GB/s ({best['tag'].strip()}), "
            f"{ceiling / (HBM_BYTES_PER_S / 1e9):.1%} of the nominal "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

        # 9. TTA8 with on-device metrics: the CAC kernels' second path
        tta, tta_wall, tta_counts, gaps, warm_dm, warm_host = \
            run_tta_path(kc, data, tmp)
        say(f"tta8 path: cli eval --tta8 --device-metrics bf16 b4, mean "
            f"RMSE {tta['mean_rmse']}, mean SSIM {tta['mean_ssim']}, "
            f"{tta_wall:.1f} s wall; launches {tta_counts}")
        say(f"tta8 metrics: card vs host on the PNGs: RMSE max |d| "
            f"{gaps['rmse_host']:.3e} (< {RMSE_HOST_TOL}), SSIM max |d| "
            f"{gaps['ssim_host']:.3e} (< {SSIM_HOST_TOL}); card vs CPU, "
            f"same tensors: RMSE {gaps['rmse_cpu']:.3e}, SSIM "
            f"{gaps['ssim_cpu']:.3e} (<= {METRIC_CPU_TOL})")
        for label, r in (("device metrics", warm_dm),
                         ("host metrics", warm_host)):
            say(f"tta8 warm, {label}: img/s steady "
                f"{r['img_per_sec_steady']}, compute+D2H "
                f"{r['img_per_sec_compute']}, end-to-end "
                f"{r['img_per_sec_e2e']}")

        # 10. fp32 TTA8 through the kernels against the plain stage
        d_tta = compare_tta_paths(data)
        say(f"fp32 tta8 b4 384x480: kernels vs plain stage max abs diff "
            f"{d_tta:.3e} (<= {FWD_TOL})")

        # 11. a 2-member ensemble with --tta
        d_ens, spread, ens, ens_wall, ens_counts = run_ensemble(kc, data,
                                                                tmp)
        say(f"ensemble x4_ship4 + x4_holdout2 --tta: fp32 vs the mean of "
            f"its members max abs diff {d_ens:.3e} (<= {FWD_TOL}; the "
            f"members differ by up to {spread:.3e}); cli eval bf16 b4 mean "
            f"RMSE {ens['mean_rmse']}, mean SSIM {ens['mean_ssim']}, "
            f"{ens_wall:.1f} s wall; launches {ens_counts}")

        # 12. the int8 forward, fp32: quant kernels vs plain, card vs CPU
        d_int8, d_int8_cpu = compare_int8_paths(data)
        say(f"fp32 int8 forward b4 384x480 (x4_ship4_qat_static): quant "
            f"kernels vs plain max abs diff {d_int8:.3e} (bitwise); card vs "
            f"CPU 37x29 mean {d_int8_cpu[0]:.3e} max {d_int8_cpu[1]:.3e} "
            f"(<= {INT8_CPU_BOUNDS[0]}, {INT8_CPU_BOUNDS[1]})")

        # 13. the int8 eval: the quant kernels' main path
        i8, i8_wall, i8_counts, i8_warm = run_int8_path(kc, kq, data, tmp)
        say(f"int8 path: cli eval --dtype int8 b4 (x4_ship4_qat_static), "
            f"mean RMSE {i8['mean_rmse']}, mean SSIM {i8['mean_ssim']}, "
            f"{i8_wall:.1f} s wall; img/s steady "
            f"{i8['img_per_sec_steady']}, end-to-end "
            f"{i8['img_per_sec_e2e']}; launches {i8_counts}")
        say(f"int8 path again, warm: img/s steady "
            f"{i8_warm['img_per_sec_steady']}, compute+D2H "
            f"{i8_warm['img_per_sec_compute']}, end-to-end "
            f"{i8_warm['img_per_sec_e2e']}")

        # 14. int8 with TTA8 and on-device metrics
        i8t, i8t_wall, i8t_counts, i8_gaps = run_int8_tta_path(kc, kq, data,
                                                               tmp)
        say(f"int8 tta8 path: cli eval --dtype int8 --tta8 --device-metrics "
            f"b4, mean RMSE {i8t['mean_rmse']}, mean SSIM "
            f"{i8t['mean_ssim']}, {i8t_wall:.1f} s wall; img/s steady "
            f"{i8t['img_per_sec_steady']}; launches {i8t_counts}")
        say(f"int8 tta8 metrics: card vs host on the PNGs: RMSE max |d| "
            f"{i8_gaps['rmse_host']:.3e}, SSIM max |d| "
            f"{i8_gaps['ssim_host']:.3e}; card vs CPU, same tensors: RMSE "
            f"{i8_gaps['rmse_cpu']:.3e}, SSIM {i8_gaps['ssim_cpu']:.3e}")

        # 15. a static + dynamic int8 ensemble with --tta
        d_i8e, i8_spread, i8e, i8e_wall, i8e_counts = run_int8_ensemble(
            kc, kq, data, tmp)
        say(f"int8 ensemble x4_ship4_qat_static + x4_ship4_qat --tta: vs the "
            f"mean of its members max abs diff {d_i8e:.3e} (<= {FWD_TOL}; "
            f"the members differ by up to {i8_spread:.3e}); cli eval b4 "
            f"mean RMSE {i8e['mean_rmse']}, mean SSIM {i8e['mean_ssim']}, "
            f"{i8e_wall:.1f} s wall; launches {i8e_counts}")

        # 16-17. the reference's .pth checkpoints: eval and convert
        t0 = time.time()
        pth_runs = run_pth_path(kc, data, tmp)
        for kind, (r, r_wall, r_counts) in pth_runs.items():
            say(f"pth path ({kind}): cli eval bf16 b4 mean RMSE "
                f"{r['mean_rmse']}, mean SSIM {r['mean_ssim']}, "
                f"{r_wall:.1f} s wall, PNGs and metrics bitwise equal to "
                f"the .npz eval; cli convert gives x4_ship4.npz's arrays; "
                f"launches {r_counts}")
        say(f"pth phases: {time.time() - t0:.1f} s")

        # 18. the merged-tower forward: float evals, fp32 forwards
        fu, fu_wall, fu_counts, fut, fut_wall, fut_counts, fu_gaps = \
            run_fused_path(kc, data, tmp)
        say(f"fused path: cli eval --variant codon_fused bf16 b4, mean RMSE "
            f"{fu['mean_rmse']}, mean SSIM {fu['mean_ssim']}, "
            f"{fu_wall:.1f} s wall; img/s steady "
            f"{fu['img_per_sec_steady']}, end-to-end "
            f"{fu['img_per_sec_e2e']}; launches {fu_counts}")
        say(f"fused tta8 path: --tta8 --device-metrics, mean RMSE "
            f"{fut['mean_rmse']}, mean SSIM {fut['mean_ssim']}, "
            f"{fut_wall:.1f} s wall; img/s steady "
            f"{fut['img_per_sec_steady']}; launches {fut_counts}; card vs "
            f"host RMSE {fu_gaps['rmse_host']:.3e}, SSIM "
            f"{fu_gaps['ssim_host']:.3e}; card vs CPU RMSE "
            f"{fu_gaps['rmse_cpu']:.3e}, SSIM {fu_gaps['ssim_cpu']:.3e}")
        d_fu, d_fu_packed = compare_fused_paths(data)
        say(f"fp32 fused forward b4 384x480: kernels vs plain stage max abs "
            f"diff {d_fu:.3e} (<= {FWD_TOL}); fused vs packed max abs diff "
            f"{d_fu_packed:.3e} (within atol {FUSED_TOL[0]}, rtol "
            f"{FUSED_TOL[1]})")

        # 19-20. the merged-tower forward in int8
        d_fu8 = compare_fused_int8_paths(data)
        say(f"fp32 fused int8 forward b4 384x480 (x4_ship4_qat_static): "
            f"quant kernels vs plain max abs diff {d_fu8:.3e} (bitwise)")
        fu8, fu8_wall, fu8_counts = run_fused_int8_path(kc, kq, data, tmp)
        say(f"fused int8 path: cli eval --variant codon_fused --dtype int8 "
            f"b4, mean RMSE {fu8['mean_rmse']}, mean SSIM "
            f"{fu8['mean_ssim']}, {fu8_wall:.1f} s wall; img/s steady "
            f"{fu8['img_per_sec_steady']}; launches {fu8_counts}")

        # 21. the sequential-tower forward
        seq = run_sequential_path(kc, kq, data, tmp)
        for dt, (r, r_wall, r_counts) in seq.items():
            say(f"sequential path: cli eval --variant rmcr_fuse_rmcr {dt} "
                f"b4, mean RMSE {r['mean_rmse']}, mean SSIM "
                f"{r['mean_ssim']}, {r_wall:.1f} s wall; img/s steady "
                f"{r['img_per_sec_steady']}; launches {r_counts}")

        # 22. the rest of the cli
        t0 = time.time()
        tools = run_cli_tools(data, tmp, os.path.join(tmp, "out"), summary)
        say(f"cli resume: first run {tools['resume']['first_images']} "
            f"images, second run's stub {json.dumps(tools['resume']['stub'])}")
        say(f"cli profile: trace of {tools['profile_trace_bytes']} bytes "
            f"with the CAC kernels in it")
        say(f"cli check-nans: FloatingPointError as expected: "
            f"{tools['check_nans']}")
        say(f"cli golden on the main eval's PNGs: {tools['golden']} (the "
            f"eval's own means)")
        say(f"cli info: {' | '.join(tools['info'])}")
        say(f"cli phases: {time.time() - t0:.1f} s")

        # 23. training gradients on the card: kernels against plain stage
        t0 = time.time()
        for r in compare_train_grads(kc, data):
            say(f"train grads {r['dtype']} b{TRAIN_BATCH} p{TRAIN_PATCH}: "
                f"loss kernels {r['loss_kernels']:.6f} plain "
                f"{r['loss_plain']:.6f} (rel {r['loss_rel']:.2e}); "
                f"gradient tree rel L2 {r['grad_tree_rel']:.2e}, worst leaf "
                f"{r['grad_worst_leaf']} {r['grad_worst_rel']:.2e} of its "
                f"max |g| (tolerances {TRAIN_TOLS[r['dtype']]})"
                + (f"; from the fp32 gradient: kernels "
                   f"{r['kernels_vs_fp32']:.3e}, plain "
                   f"{r['plain_vs_fp32']:.3e}" if "plain_vs_fp32" in r
                   else "")
                + f"; every leaf but the dead heads has a gradient; CAC "
                  f"launches a step {r['launches']}, none in the backward")

        # 24. cli train: the training path
        tr = run_train_path(kc, kq, data, tmp)
        train_counts = tr["train"]["counts"]
        say(f"train path: cli train bf16 b{TRAIN_BATCH} p{TRAIN_PATCH} "
            f"{TRAIN_STEPS} steps from x4_ship4 (warmup 5, clip 1, ema "
            f"0.999, checkpoints every 10), losses {tr['train']['losses']}, "
            f"{tr['train']['wall_s']:.1f} s wall; launches {train_counts}")
        say(f"train resume: interrupted after step 10, resumed to "
            f"{TRAIN_STEPS}: batches bitwise, params max |d| "
            f"{tr['resume']['max_abs_diff']:.3e} (<= "
            f"{tr['resume']['bound']:.1e})")
        q = tr["qat_static"]
        say(f"train --qat-static from x4_ship4_qat_static, 10 steps: "
            f"losses {q['losses']}, {q['wall_s']:.1f} s wall, launches "
            f"{q['counts']}; cli eval --dtype int8 of its output: mean RMSE "
            f"{q['int8_rmse']}, mean SSIM {q['int8_ssim']}")
        say(f"train on synthesized degradation, 5 steps: losses "
            f"{tr['synthesized']['losses']}")
        b1 = run_batch1_step(kc, data)
        say(f"train batch 1 bf16 p{TRAIN_PATCH} from x4_ship4: loss "
            f"{b1['loss']:.6f}, grad_norm {b1['grad_norm']:.4f}; launches "
            f"{b1['counts']}")

        # 25-26. training times and the device's idle share
        tt = time_training(kc, data)
        for dtype in ("bf16", "fp32"):
            r = tt[dtype]
            say(f"train time {dtype} b{TRAIN_BATCH} p{TRAIN_PATCH}: "
                f"{r['step_ms']:.3f} ms a step, {r['patches_per_s']:.0f} "
                f"patches/s; forward {r['split_ms']['forward']:.3f}, "
                f"backward {r['split_ms']['backward']:.3f}, optimizer "
                f"{r['split_ms']['optimizer']:.3f} ms ({card})")
        say(f"train sampler (host): {tt['sampler_ms']:.3f} ms a batch of "
            f"{TRAIN_BATCH} patches")
        lp = tt["loop"]
        say(f"train loop bf16, {lp['steps']} steps profiled: "
            f"{lp['wall_ms_a_step']:.3f} ms a step wall, "
            f"{lp['device_ms_a_step']:.3f} ms device, idle share "
            f"{lp['idle_share']:.1%} ({card})")
        say(f"train phases: {time.time() - t0:.1f} s")

        # 27. every zoo net at the cell shape
        t0 = time.time()
        zoo_rows = []
        for r in run_zoo_nets(kc, kq, data):
            zoo_rows.append(r)
            say(f"zoo {r['name']} b4 384x480 masked, own init, "
                f"{r['params']} params: bf16 {r['bf16_ms']:.3f} ms, fp32 "
                f"{r['fp32_ms']:.3f} ms a forward ({card}); bf16 vs fp32 "
                f"mean |d| {r['bf16_rel_mean']:.3e} of mean |y| "
                f"{r['mean_abs_y']:.4g} (<= {ZOO_BF16_REL})"
                + (f"; masked batch vs each image alone max |d| "
                   f"{r['per_image_max_abs_diff']:.3e}"
                   if "per_image_max_abs_diff" in r else "")
                + "; no kernel launched")
        say(f"zoo nets: {len(zoo_rows)}, bf16 vs fp32 worst mean |d| "
            f"{max(r['bf16_rel_mean'] for r in zoo_rows):.3e} of mean |y|; "
            f"{time.time() - t0:.1f} s")

        # 28. the zoo's CODONNet against the kernel path
        zc, zc_zoo, zc_codon = compare_zoo_codon(kc, data)
        say(f"zoo CODON ({ZOO_CODON}) on x4_ship4 vs codon with the CAC "
            f"kernels, first batch: fp32 max |d| {zc['fp32']:.3e} (<= "
            f"{FWD_TOL}), bf16 {zc['bf16']:.3e} (<= {ZOO_CODON_BF16_ATOL}); "
            f"launches over both: zoo {zc_zoo}, codon {zc_codon}")

        # 29. cli eval of zoo nets with TTA8 and metrics on the card
        zev = run_zoo_evals(kc, kq, data, tmp)
        for name, (r, r_wall, r_counts) in zev.items():
            say(f"zoo eval: cli eval --variant zoo:{name} --tta8 "
                f"--device-metrics bf16 b4 (own init), mean RMSE "
                f"{r['mean_rmse']}, mean SSIM {r['mean_ssim']}, "
                f"{r_wall:.1f} s wall; img/s steady "
                f"{r['img_per_sec_steady']}; launches {r_counts}")

        # 30. the zoo in int8: the narrow sites on the quant kernels
        z8 = run_zoo_int8(kc, kq, data, tmp)
        for name, r in z8.items():
            say(f"zoo int8: zoo:{name} fp32 dynamic int8 forward, quant "
                f"kernels vs plain max |d| {r['fp32_kernels_vs_plain']:.3e} "
                f"(bitwise); cli eval --dtype int8 b4, mean RMSE "
                f"{r['summary']['mean_rmse']}, mean SSIM "
                f"{r['summary']['mean_ssim']}, img/s steady "
                f"{r['summary']['img_per_sec_steady']}; "
                f"{r['quantized_calls_a_forward']} quantized conv calls a "
                f"forward, {r['narrow_calls_a_forward']} of them narrow "
                f"(padded); launches {r['counts']}")

        # 31. cli train of zoo nets
        ztr = run_zoo_train(kc, data, tmp)
        for name, r in ztr.items():
            say(f"zoo train: cli train --variant zoo:{name} bf16 "
                f"b{TRAIN_BATCH} p{TRAIN_PATCH} {ZOO_TRAIN_STEPS} steps "
                f"(own init, weight decay {ZOO_WEIGHT_DECAY}), losses "
                f"{r['losses']}, {r['wall_s']:.1f} s wall; "
                f"{r['unread_leaves']} unread leaves moved by the decay "
                f"alone (max |d| {r['unread_max_abs_diff']:.3e}); launches "
                f"{r['counts']}")
        say(f"zoo phases: {time.time() - t0:.1f} s")

        # 32. export and serve: the matrix, cli export, and every artifact
        # in a process without the model code
        t0 = time.time()
        matrix, serve_rows, serve_proc = run_serve_path(kc, kq, data, tmp)
        for r in matrix:
            say(f"export matrix {r['artifact']}: {r['size_mb']:.2f} MB, "
                f"export {r['export_s']:.2f} s, load {r['load_s']:.3f} s, "
                f"first call {r['first_call_s']:.3f} s, steady call "
                f"{r['steady_call_s'] * 1e3:.2f} ms (b1, {r['card']})")
        for r in serve_rows:
            say(f"serve {r['name']} ({r['said']}): b1/b2/b4 from a process "
                f"without the model code, vs the live forward max |d| "
                f"{r['max_abs_diff']:.3e} (bitwise "
                f"{r['max_abs_diff'] == 0.0}; bound {r['tol']}); launches "
                f"as live {r['counts'][4]} at b4; steady b4 call artifact "
                f"{r['artifact_ms']:.3f} ms, live {r['live_ms']:.3f} ms; "
                f"b1 latency (host clock, median of 5) artifact "
                f"{r['artifact_b1_ms']:.3f} ms, live {r['live_b1_ms']:.3f} "
                f"ms ({card})")
        say(f"serve process: TF32 on by default {serve_proc['tf32_default']}"
            f", after the calls {serve_proc['tf32_after']}; model modules "
            f"imported {serve_proc['model_modules']}; "
            f"{serve_proc['wall_s']:.1f} s wall")
        say(f"serve phase: {time.time() - t0:.1f} s")

        # 33. the mesh: sharded forwards on 4 gloo ranks sharing the card
        t0 = time.time()
        mesh = run_mesh_phase(kc, kq, data, tmp, {
            "bf16": (tta, os.path.join(tmp, "tta8_dm")),
            "int8": (i8t, os.path.join(tmp, "int8_tta8"))})
        for dtype, (r, r_wall, r_counts, gap) in mesh["cli"].items():
            say(f"mesh cli: cli eval --tile-devices 2 --dp-devices 2 "
                f"--dist-backend gloo --tta8 --device-metrics {dtype} b4, "
                f"mean RMSE {r['mean_rmse']}, mean SSIM {r['mean_ssim']}, "
                f"{r_wall:.1f} s wall (pool start included); vs the "
                f"single-device eval: PNG mean |d| <= "
                f"{gap['png_mean']:.4f}, max <= {gap['png_max']:.0f} levels, "
                f"RMSE |d| <= {gap['rmse']:.4f}, SSIM |d| <= "
                f"{gap['ssim']:.2e}; rank 0 launches {r_counts}")
            ranks = r["mesh"]["ranks"]
            say(f"mesh cli {dtype} by rank (--json's mesh entry): CAC "
                f"launches {[c['cac']['cac_stats'] for c in ranks]}, quant "
                f"{[c['quant']['quant_im2col'] for c in ranks]}; "
                + "; ".join(f"rank {i} {comm_text(c['comm'])}"
                            for i, c in enumerate(ranks)))
        say(f"mesh pool: {MESH_WORLD} gloo ranks on one card, started in "
            f"{mesh['pool_start_s']:.1f} s; transport {mesh['transport']}")
        say(f"mesh single-device b4 384x480: bf16 "
            f"{mesh['single_ms']['bf16']:.2f} ms, fp32 "
            f"{mesh['single_ms']['fp32']:.2f} ms, int8 static "
            f"{mesh['int8_single_ms']['static']:.2f} ms, dynamic "
            f"{mesh['int8_single_ms']['dynamic']:.2f} ms ({card})")
        for r in mesh["forms"]:
            if "class" in r:
                cmp = (f"vs single mean {r['class'][0]:.3e} max "
                       f"{r['class'][1]:.3e} (bf16 vs fp32 mean "
                       f"{r['class'][2]:.3e} max {r['class'][3]:.3e})")
            elif "flip" in r:
                cmp = (f"vs unsharded mean {r['flip'][0]:.3e} max "
                       f"{r['flip'][1]:.3e} (<= {INT8_CPU_BOUNDS})")
            else:
                cmp = (f"vs single max |d| {r['max_abs_diff']:.3e} "
                       f"(atol/rtol {MESH_FP32_TOL})"
                       + (f", kernels vs plain stage "
                          f"{r['kernel_vs_plain']:.3e} (<= {FWD_TOL})"
                          if "kernel_vs_plain" in r else ""))
            say(f"mesh {r['dtype']} {r['form']} b4 384x480: {cmp}; wall "
                f"{r['ms']:.2f} ms a forward"
                + (f" (single {r['single_ms']:.2f})" if "single_ms" in r
                   else "")
                + f", ranks sharing one H100 over gloo ({card}); launches "
                  f"by rank "
                + str([{**c["cac"], **{k: c["quant"][k] for k in
                                       ("quant_im2col", "dequant_epilogue")}}
                       for c in r["counts"]]))
            say(f"mesh {r['dtype']} {r['form']} rank 0 collectives: "
                f"{comm_text(r['counts'][0]['comm'])}")
        lg = mesh["large"]
        say(f"mesh large frame {LARGE_FRAME[0]}x{LARGE_FRAME[1]} b1 bf16 "
            f"1x2: vs untiled mean {lg['class'][0]:.3e} max "
            f"{lg['class'][1]:.3e} (bf16 vs fp32 mean {lg['class'][2]:.3e} "
            f"max {lg['class'][3]:.3e}); wall {lg['ms']:.2f} ms, untiled "
            f"{lg['single_ms']:.2f} ms (ranks sharing one H100 over gloo); "
            f"tile_stitch_infer mean |d| {lg['stitch_mean']:.3e} (< "
            f"{STITCH_MEAN_TOL}), {lg['stitch_s']:.2f} s; launches "
            f"{[c['cac'] for c in lg['counts']]}")
        nc = mesh["nccl"]
        say(f"mesh nccl: 2 ranks on 1 card refused ({nc['refusal']}); "
            f"one-rank NCCL group, ShardedOps forward bf16 b4 vs single mean "
            f"{nc['class'][0]:.3e} max {nc['class'][1]:.3e}; transport "
            f"{nc['transport']}; {comm_text(nc['comm'])}")
        for r in mesh["halo_routes"]:
            say(f"mesh haloed int8 conv k{r['k']} C{r['c']} 4x(192+"
                f"{r['k'] - 1})x480 int8 in, bf16 out: gather with halo rows "
                f"device {r['halo_device_ms']:.4f} ms (back to back "
                f"{r['halo_ms']:.4f}), SAME gather + GEMM + crop device "
                f"{r['crop_device_ms']:.4f} ms ({r['crop_ms']:.4f}) "
                f"({card}); the haloed quant_im2col and int8_conv bitwise "
                f"their plain versions, int8 in and bf16 in on a "
                f"per-image scale, masked")
        say(f"mesh phase: {time.time() - t0:.1f} s")

        # 34. sharded training on 4 gloo ranks sharing the card
        t0 = time.time()
        mt = run_mesh_train_phase(kc, data)
        say(f"mesh train pool: {MESH_WORLD} gloo ranks on one card, started "
            f"in {mt['pool_start_s']:.1f} s")
        for r in mt["forms"]:
            say(f"mesh train {r['dtype']} {r['form']}: loss sharded "
                f"{r['loss']:.6f} single {r['loss_single']:.6f} (rel "
                f"{r['loss_rel']:.2e}); gradient tree rel L2 "
                f"{r['grad_tree_rel']:.2e}, worst leaf "
                f"{r['grad_worst_leaf']} {r['grad_worst_rel']:.2e} of its "
                f"max |g|"
                + (f"; from the fp32 gradient: sharded "
                   f"{r['sharded_vs_fp32']:.3e}, single "
                   f"{r['single_vs_fp32']:.3e}" if "sharded_vs_fp32" in r
                   else "")
                + f"; params after a step max |d| "
                  f"{r['param_max_abs_diff']:.3e} (<= "
                  f"{MESH_TRAIN_PARAM_LRS} lr); replicas {r['replicas']} "
                  f"steps; wall {r['ms']:.2f} ms a step, single "
                  f"{r['single_ms']:.2f} ms, ranks sharing one H100 over "
                  f"gloo ({card}); CAC launches a step by rank "
                  f"{[c['cac']['cac_stats'] for c in r['counts']]} (none in "
                  f"the backward), stage calls by rank "
                  f"{[c['stages'] for c in r['counts']]}")
            say(f"mesh train {r['dtype']} {r['form']} collectives a step by "
                f"rank: " + "; ".join(f"rank {i} {comm_text(c['comm'])}"
                                      for i, c in enumerate(r["counts"])))
        nc = mt["nccl"]
        say(f"mesh train nccl: one-rank NCCL group, bf16 step vs single: "
            f"loss rel {nc['loss_rel']:.2e}, gradient tree rel L2 "
            f"{nc['grad_tree_rel']:.2e}, worst leaf {nc['grad_worst_rel']:.2e}"
            f"; transport {nc['transport']}; {comm_text(nc['comm'])}")
        say(f"mesh train phase: {time.time() - t0:.1f} s")

        # 35-36. the zoo over the mesh, and codon_fused training (its
        # sharded step on the same pool)
        from codon_tpu_torch.parallel import MeshPool
        t0 = time.time()
        with MeshPool(MESH_WORLD, device=DEVICE, backend="gloo",
                      timeout_s=300) as pool:
            say(f"zoo mesh pool: {MESH_WORLD} gloo ranks on one card, "
                f"started in {time.time() - t0:.1f} s")
            zm = run_zoo_mesh_phase(kc, kq, data, pool)
            t1 = time.time()
            ft = run_fused_train_phase(kc, data, tmp, pool)
            fused_s = time.time() - t1
        need(not any(proc.is_alive() for proc in pool._procs),
             "a mesh rank outlived its pool")
        zm["cli"] = run_zoo_mesh_cli(kc, data, tmp, zev)
        n2, (sdp, ssp) = ZOO_MESH_SWEEP
        for r in zm["sweep"]:
            say(f"zoo mesh {r['name']} fp32 {sdp}x{ssp} b{n2} 384x480 "
                f"masked, own init: vs single max |d| "
                f"{r['max_abs_diff']:.3e} (atol/rtol {MESH_FP32_TOL}; max "
                f"|y| {r['max_abs_y']:.4g}); wall {r['ms']:.2f} ms a "
                f"forward, ranks sharing one H100 over gloo ({card}); no "
                f"CAC launch or stage call on any rank")
        say(f"zoo mesh sweep: {len(zm['sweep'])} nets, worst max |d| "
            f"{max(r['max_abs_diff'] for r in zm['sweep']):.3e}")
        for r in zm["forms"]:
            if "fp32_class" in r:
                fc = r["fp32_class"]
                cmp = (f"vs the fp32 {'int8 ' if 'int8' in r['dtype'] else ''}"
                       f"forward mean {fc[0]:.3e} max {fc[1]:.3e} (single "
                       f"bf16 mean {fc[2]:.3e} max {fc[3]:.3e}; <= "
                       f"{BF16_CLASS}x mean, 2x max)")
            else:
                cmp = (f"its 1e-6 input change moves the unsharded forward "
                       f"mean {r['perturbed'][0]:.3e} max "
                       f"{r['perturbed'][1]:.3e}; b{ZOO_INT8_SMALL[0]} "
                       f"{ZOO_INT8_SMALL[1]}x{ZOO_INT8_SMALL[2]} frame vs "
                       f"unsharded mean {r['small'][0]:.3e} max "
                       f"{r['small'][1]:.3e} (<= {INT8_CPU_BOUNDS})")
            if "vs_single" in r:
                cmp = (f"bitwise its plain-quant twin; vs unsharded mean "
                       f"{r['vs_single'][0]:.3e} max {r['vs_single'][1]:.3e}"
                       f"; {cmp}")
            if "c5" in r:
                c5 = r["c5"]
                cmp += (f"; vs the unsharded forward a dp block at a time "
                        f"mean {c5['vs_blocks'][0]:.3e} max "
                        f"{c5['vs_blocks'][1]:.3e}; pools in the "
                        f"single-device order: vs production mean "
                        f"{c5['single_order_vs_production'][0]:.3e} max "
                        f"{c5['single_order_vs_production'][1]:.3e}, vs "
                        f"unsharded mean "
                        f"{c5['single_order_vs_single'][0]:.3e} max "
                        f"{c5['single_order_vs_single'][1]:.3e}, vs a dp "
                        f"block at a time mean "
                        f"{c5['single_order_vs_blocks'][0]:.3e} max "
                        f"{c5['single_order_vs_blocks'][1]:.3e} (<= "
                        f"{INT8_CPU_BOUNDS})")
            say(f"zoo mesh {r['name']} {r['dtype']} {r['form']} b4 384x480 "
                f"masked: {cmp}; wall {r['ms']:.2f} ms a forward"
                + (f" (single {r['single_ms']:.2f})" if "single_ms" in r
                   else "")
                + f", ranks sharing one H100 over gloo ({card}); launches by "
                  f"rank " + str([{"cac": sum(c["cac"].values()),
                                   **{k: c["quant"][k] for k in
                                      ("quant_im2col", "dequant_epilogue")}}
                                  for c in r["counts"]]))
        for r in zm["train"]:
            say(f"zoo mesh train {r['name']} {r['dtype']} 2x2 b{TRAIN_BATCH} "
                f"p{TRAIN_PATCH}: loss sharded {r['loss']:.6f} single "
                f"{r['loss_single']:.6f} (rel {r['loss_rel']:.2e}); gradient "
                f"tree rel L2 {r['grad_tree_rel']:.2e}, worst leaf "
                f"{r['grad_worst_leaf']} {r['grad_worst_rel']:.2e} of its max "
                f"|g|"
                + (f"; from the fp32 gradient: sharded "
                   f"{r['sharded_vs_fp32']:.3e}, single "
                   f"{r['single_vs_fp32']:.3e}" if "sharded_vs_fp32" in r
                   else "")
                + f"; params after a step max |d| "
                  f"{r['param_max_abs_diff']:.3e} (<= {MESH_TRAIN_PARAM_LRS} "
                  f"lr); replicas {r['replicas']} steps; wall {r['ms']:.2f} "
                  f"ms a step, single {r['single_ms']:.2f} ms, ranks sharing "
                  f"one H100 over gloo ({card}); CAC launches by rank "
                  f"{[sum(c['cac'].values()) for c in r['counts']]}")
        r, r_wall, r_counts, gap = zm["cli"]
        say(f"zoo mesh cli: cli eval --variant zoo:{ZOO_MESH_CLI} "
            f"--tile-devices 2 --dp-devices 2 --dist-backend gloo --tta8 "
            f"--device-metrics bf16 b4 (own init), mean RMSE "
            f"{r['mean_rmse']}, mean SSIM {r['mean_ssim']}, {r_wall:.1f} s "
            f"wall (pool start included); vs phase 29's single-device eval: "
            f"PNG mean |d| <= {gap['png_mean']:.4f}, max <= "
            f"{gap['png_max']:.0f} levels (class {MESH_CLI_PNG['bf16']}), "
            f"RMSE |d| <= {gap['rmse']:.4f}, SSIM |d| <= {gap['ssim']:.2e}; "
            f"rank "
            f"0 launches {r_counts}; by rank quant "
            f"{[c['quant']['quant_im2col'] for c in r['mesh']['ranks']]}")
        say(f"zoo mesh phase: {time.time() - t0 - fused_s:.1f} s")

        # 36. codon_fused training
        for r in ft["grads"]:
            say(f"fused train grads {r['dtype']} b{TRAIN_BATCH} "
                f"p{TRAIN_PATCH} x4_ship4: kernel step loss {r['loss']:.6f}"
                + "".join(
                    f"; vs {tag} loss rel {r[tag]['loss_rel']:.2e}, tree "
                    f"{r[tag]['grad_tree_rel']:.2e}, worst leaf "
                    f"{r[tag]['grad_worst_leaf']} "
                    f"{r[tag]['grad_worst_rel']:.2e}"
                    for tag in ("plain", "codon") if tag in r)
                + (f"; from the fp32 gradient: kernels "
                   f"{r['kernels_vs_fp32']:.3e}, plain "
                   f"{r['plain_vs_fp32']:.3e}" if "kernels_vs_fp32" in r
                   else "")
                + "; CAC 5 each a step, none in the backward")
        for dtype in ("bf16", "fp32"):
            say(f"fused train time {dtype} b{TRAIN_BATCH} p{TRAIN_PATCH}: "
                f"codon_fused {ft['time'][dtype, 'codon_fused']:.3f} ms a "
                f"step, codon {ft['time'][dtype, 'codon']:.3f} ms "
                f"({TIME_ITERS} steps between CUDA events, {card})")
            c = ft["cli"][dtype]
            say(f"fused train cli: cli train --variant codon_fused {dtype} "
                f"from x4_ship4, {FUSED_TRAIN_STEPS} steps: losses "
                f"{c['losses']}, {c['wall_s']:.1f} s wall; launches "
                f"{c['counts']}")
        r = ft["mesh"]
        say(f"fused train mesh bf16 2x2: loss sharded {r['loss']:.6f} single "
            f"{r['loss_single']:.6f} (rel {r['loss_rel']:.2e}); gradient "
            f"tree rel L2 {r['grad_tree_rel']:.2e}, worst leaf "
            f"{r['grad_worst_leaf']} {r['grad_worst_rel']:.2e}; params after "
            f"a step max |d| {r['param_max_abs_diff']:.3e}; replicas "
            f"{r['replicas']} steps; wall {r['ms']:.2f} ms a step, single "
            f"{r['single_ms']:.2f} ms (ranks sharing one H100 over gloo, "
            f"{card}); CAC launches a step by rank "
            f"{[c['cac']['cac_stats'] for c in r['counts']]}, stage calls "
            f"{[c['stages'] for c in r['counts']]}")
        say(f"fused train phase: {fused_s:.1f} s")

        # 37. the tools and the pyramid sampler
        t0 = time.time()
        tl = run_tools_phase(kc, data, tmp)
        say(f"tools soup: {tl['soup_said']}; cli eval bf16 b4 of the soup: "
            f"mean RMSE {tl['soup_eval']['mean_rmse']}, mean SSIM "
            f"{tl['soup_eval']['mean_ssim']}, {tl['soup_eval']['wall_s']:.1f}"
            f" s wall; launches {tl['soup_eval']['counts']}")
        for row in tl["sc_rows"]:
            say(f"tools sc_cond_probe: {json.dumps(row)}")
        ps = tl["pyramid_step"]
        say(f"tools pyramid: PatchSampler(pyramid={PYRAMID}) over "
            f"{len(SCENES)} scenes, levels {tl['pyramid_sizes']} (first "
            f"scene) built in {tl['pyramid_build_ms']:.1f} ms (host), a "
            f"b{TRAIN_BATCH} p{TRAIN_PATCH} batch in "
            f"{tl['pyramid_sample_ms']:.1f} ms; one bf16 step on the card: "
            f"loss {ps['loss']:.6f}, grad_norm {ps['grad_norm']:.4f}, "
            f"launches {ps['counts']}")
        say(f"tools phase: {time.time() - t0:.1f} s")

        # 38. entry() and the last two model scripts
        t0 = time.time()
        pr = run_probes_phase(kc, data, tmp)
        e = pr["entry"]
        say(f"probes entry: bf16 codon {e['shape']} {e['dtype']}, finite "
            f"{e['finite']}, first call {e['ms']:.1f} ms; launches "
            f"{e['counts']}")
        sh = pr["shift"]
        say(f"probes tta_shift_probe: x4_holdout2 bf16 TTA4 over "
            f"{len(SCENES)} scenes b4, {len(sh['json']['per_image'])} rows, "
            f"mean tta4 RMSE {sh['json']['mean_tta4']}, mean shift5 RMSE "
            f"{sh['json']['mean_shift5']}; {sh['wall_s']:.1f} s wall; "
            f"launches {sh['counts']}")
        for r in sh["json"]["per_image"]:
            say(f"probes tta_shift_probe row: {json.dumps(r)}")
        tt = pr["ttt"]
        say(f"probes ttt_probe: x4_holdout2 bf16, {TTT_STEPS} steps "
            f"(warmup {TTT_WARMUP}) a scene, --tta, mean RMSE before "
            f"{tt['json']['mean_before']} after {tt['json']['mean_after']}; "
            f"{tt['wall_s']:.1f} s wall; launches {tt['counts']}")
        for r in tt["json"]["results"]:
            say(f"probes ttt_probe row: {json.dumps(r)}")
        al = pr["ttt_alone"]
        say(f"probes ttt_probe alone: {al['row']['name']} rmse_before "
            f"{al['row']['rmse_before']} (the same in the "
            f"{len(tt['json']['results'])}-scene run), rmse_after "
            f"{al['row']['rmse_after']}, ttt_s {al['row']['ttt_s']:.2f}; "
            f"launches {al['counts']}")
        say(f"probes phase: {time.time() - t0:.1f} s (the card holds "
            f"synthetic scenes only: the round-3 negatives need Middlebury)")

    # 39. results
    int8_paths = {"eval_int8": i8_counts,
                  "eval_int8_tta8_device_metrics": i8t_counts,
                  "eval_int8_ensemble2_tta": i8e_counts,
                  "eval_codon_fused_int8": fu8_counts,
                  "eval_rmcr_fuse_rmcr_int8": seq["int8"][2]}
    int8_paths.update({f"eval_zoo_{n}_int8": r["counts"]
                       for n, r in z8.items()})
    cac_paths = {"eval_codon_fused": fu_counts,
                 "eval_codon_fused_tta8_device_metrics": fut_counts,
                 "eval_rmcr_fuse_rmcr": seq["bf16"][2],
                 **{f"eval_pth_{k}": v[2] for k, v in pth_runs.items()},
                 "train_batch1": b1["counts"],
                 "zoo_codon_entry": zc_zoo, "codon_beside_zoo": zc_codon,
                 **{f"eval_zoo_{n}_tta8_device_metrics": v[2]
                    for n, v in zev.items()},
                 **{f"train_zoo_{n}": r["counts"] for n, r in ztr.items()},
                 **{f"train_codon_fused_cli_{k}": v["counts"]
                    for k, v in ft["cli"].items()},
                 "eval_soup": tl["soup_eval"]["counts"],
                 "train_pyramid_step": tl["pyramid_step"]["counts"],
                 "entry": pr["entry"]["counts"],
                 "tta_shift_probe": pr["shift"]["counts"],
                 "ttt_probe_tta": pr["ttt"]["counts"],
                 "ttt_probe_tta_alone": pr["ttt_alone"]["counts"]}
    # the artifacts' launches in the serving process, batches 1 + 2 + 4
    serve_paths = {f"serve_{r['name']}": {k: sum(c[k] for c in
                                                 r["counts"].values())
                                          for k in r["counts"][4]}
                   for r in serve_rows}
    # the mesh's launches, a list by rank (rank 0 only for the cli evals,
    # whose pool is the cli's own)
    mesh_paths = {f"mesh_{r['dtype'].replace(' ', '_')}_{r['form']}":
                  r["counts"] for r in mesh["forms"]}
    mesh_paths["mesh_large_frame_bf16_1x2"] = mesh["large"]["counts"]
    # the sharded training step's, a step a rank (forward only)
    mesh_paths.update({f"mesh_train_{r['dtype'].replace(' ', '_')}_"
                       f"{r['form']}": r["counts"] for r in mt["forms"]})
    mesh_paths["mesh_train_bf16_codon_fused_2x2"] = ft["mesh"]["counts"]
    # the zoo over the mesh: no CAC launch on any rank; the dynamic int8
    # forms' quant launches by rank
    mesh_paths.update({f"mesh_zoo_{r['name']}_fp32_{sdp}x{ssp}":
                       r["counts"] for r in zm["sweep"]})
    mesh_paths.update({f"mesh_{'int8_' if 'int8' in r['dtype'] else ''}"
                       f"zoo_{r['name']}_{r['dtype'].replace(' ', '_')}_"
                       f"{r['form']}": r["counts"] for r in zm["forms"]})
    mesh_paths.update({f"mesh_train_zoo_{r['name']}_{r['dtype']}_2x2":
                       r["counts"] for r in zm["train"]})
    kernels = []
    for name in ("cac_stats", "spatial_logits", "cac_apply"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/cac.cu",
            "replaces": REPLACES[name], "launches": train_counts[name],
            "launches_by_path": {"train": train_counts[name],
                                 "train_qat_static": q["counts"][name],
                                 "eval": counts[name],
                                 "eval_tta8_device_metrics": tta_counts[name],
                                 "eval_ensemble2_tta": ens_counts[name],
                                 **{p: c[name] for p, c in
                                    int8_paths.items()},
                                 **{p: c[name] for p, c in
                                    cac_paths.items()},
                                 **{p: c[name] for p, c in
                                    serve_paths.items()},
                                 **{p: [r["cac"][name] for r in c]
                                    for p, c in mesh_paths.items()},
                                 **{f"mesh_cli_{k}_rank0": v[2][name]
                                    for k, v in mesh["cli"].items()},
                                 f"mesh_cli_zoo_{ZOO_MESH_CLI}_rank0":
                                     zm["cli"][2][name]},
            **({"pitched": {"by_shape": ptimes[name],
                            "max_abs_err": max(r["max_abs_err"]
                                               for r in pchecks[name])}}
               if name in ptimes else {}),
            **({"repeats": rchecks} if name == "cac_stats" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in
                               checks[name] + pchecks.get(name, [])),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "by_shape": t["by_shape"], **({"small": t["small"]}
                                         if "small" in t else {}),
            "shape": list(MAIN_SHAPE), "dtype": "bfloat16"})
    for name, kind, tiles in COPY_KERNELS:
        t = copy_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/copy.cu",
            "replaces": REPLACES[name], "launches": copy_counts[name],
            "launches_by_path": {"perf_copy_probe": copy_counts[name]},
            "max_abs_err": max(r["max_abs_err"] for r in copy_checks
                               if r["name"] == name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "tile": t["tile"],
            "design": t["design"], "grid": t["grid"],
            "chunk_bytes": t["chunk_bytes"], "by_tile": t["by_tile"],
            "shape": list(probe.view(torch.empty(PROBE_SHAPE, device="meta"),
                                     kind).shape),
            "dtype": "bfloat16"})
    for name in ("quant_im2col", "dequant_epilogue"):
        t = qtimes[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/quant.cu",
            "replaces": REPLACES[name], "launches": i8_counts[name],
            "launches_by_path": {**{p: c[name] for p, c in
                                    int8_paths.items()},
                                 **{p: c[name] for p, c in
                                    serve_paths.items()},
                                 **{p: [r["quant"][name] for r in c]
                                    for p, c in mesh_paths.items()
                                    if p.startswith("mesh_int8")}},
            "max_abs_err": max(r["max_abs_err"] for r in
                               qchecks[name] + wchecks[name]),
            "windowed": {"grouped_sites": wtimes, "max_abs_err": max(
                r["max_abs_err"] for r in wchecks[name])},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "device_ms": t["device_ms"],
            "device_ms_a_forward": t["device_ms_a_forward"],
            "bound_ms_a_forward": t["bound_ms_a_forward"],
            "by_shape": t["by_shape"], "shape": t["shape"],
            "dtype": "bfloat16",
            **({"int8_gemm": gemms, "halo_routes": mesh["halo_routes"]}
               if name == "quant_im2col" else {})})
    for k in kernels:
        # the same numbers under the names the port's records use
        k["max_err"] = k["max_abs_err"]
        k["kernel_ms"] = k["ms"]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
