#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (built for an H100).

    python3 chip_smoke.py

Run from the root of a checkout (``--phases 2`` stops after the kernel checks,
``--phases 9``, ``10``, ``11`` or ``12`` runs phase 1, phase 3's set-up and
predict run, and that phase alone, ``--phases 13`` phase 1 and phase 13; none
of these prints result lines).
Phases:

1. Setup: torch/CUDA versions, the card's name and power limit, TF32 off for
   the plain references, and the kernels built from the checkout's sources.
2. Kernels against their plain torch versions on the card, at every shape
   the flagship cascade's predict path and training path give them: the
   predict shapes, the train steps (fine b1 128^3, coarse b1 64^3) forward
   and backward (conv dgrad is the conv kernel with Ci and Co swapped), and
   the whole-canvas evals (160,224,160) and (80,112,80). Tolerances: conv and
   IN dx max|d|/max|ref| <= 1e-2 against f32 math on the same bf16 inputs
   rounded to bf16 (the conv also: a repeat run bitwise equal, the instance
   the planner chose and the launch counters show, the mma.sync kernel
   ``conv3d.cu`` held to the same reference and tolerance and timed in the
   same call as ``prev_ms``, achieved TFLOP/s and the plan's flop per filled
   byte; and three shapes with Ci % 16 or Co % 8 nonzero, which the planner
   must send to ``conv3d.cu``);
   IN+act forward <= 2 bf16 ulp, a repeat run bitwise equal, and the bytes/s
   of the bytes its bound counts; dgamma/dbeta (f32 sums in
   another order) max|d|/max|ref| <= 1e-3; 2x down/up and their backwards
   <= 1 bf16 ulp. Device time of both (repeated calls replayed from one
   CUDA graph), and their back-to-back wall time (CUDA events), which for a
   small call reads the wrapper's host launch cost. The Winograd conv at
   every conv shape of the predict path against its plain version (the same
   decomposition in f32 on the same bf16 inputs, rounded to bf16):
   max|d|/max|ref| <= 2e-2 (U is rounded to bf16 once, V after each of its
   three axis passes in the wgmma instance ``winograd3d_wgmma.cu`` and once in
   the mma.sync instance ``winograd3d.cu``; H100 readings 5.3e-3 to 7.7e-3,
   the direct kernel's 2.6e-3 to 5.3e-3), a repeat run bitwise equal, the
   instance the planner chose and the launch counters show, ``winograd3d.cu``
   held to the same reference and timed in the same call as ``prev_ms``, and
   three odd-channel shapes through the Winograd seam to ``winograd3d.cu``.
   The IN+act forward of the predict path takes its statistics from the
   conv's epilogue: at every conv that an IN follows (predict, train and
   eval shapes) the STATS conv's y bitwise equal to the conv's without it,
   its partials bitwise repeatable, the merged mean and rstd within 1e-5
   relative of y's plain statistics, and IN+act from the partials within 2
   bf16 ulp of the plain version and bitwise repeatable; at the predict
   shapes the three terms of its time (the epilogue: STATS conv less the
   conv, timed in turns; the merge; the apply) beside the three-launch
   forward (``prev_ms``). The 2x up (``csrc/resize2x.cu``) is held to 1 bf16
   ulp with the Triton kernel (``prev_ms``) held to the same, and at the
   predict shapes written into the decoder's concat buffer: up half within 1
   ulp, skip half bitwise, timed against the Triton up followed by
   ``torch.cat``. The IN+act backward (``csrc/in_act_bwd.cu``, one
   cooperative launch) and the 2x up backward (``csrc/resize2x.cu``, read in
   place from the concat gradient's up half at its channel pitch) at every
   train shape and at edge shapes (C = 48, an odd extent, a size-1 axis; C =
   12 goes to the Triton kernels by plan): their tolerances as above, a
   repeat run bitwise equal, the route the counters show, and the Triton
   kernels they replaced held to the same and timed in the same run as
   ``prev_ms`` (the up backward's after the copy of the up half it needed).
   Beside every
   kernel of the record, at the same shapes: its bound (the larger of bytes
   over 3.35 TB/s and operations over the peak of their type) and the device
   time of the one PyTorch call that computes the same function (bf16
   channels_last_3d ``F.conv3d``, ``F.instance_norm`` + relu,
   ``F.avg_pool3d``, ``F.interpolate``; for a backward kernel that call's
   autograd backward, read as forward+backward minus forward).
   The f32 routes (the configurations whose compute dtype is float32): the
   FFMA instance of ``csrc/conv3d.cu``, the IN+act forward and backward, and
   the f32 instances of ``csrc/resize2x.cu`` (down, up and both backwards;
   the up backward read in place from a concat gradient at its real pitch),
   at the accuracy config's forward at its TTA tile batch (8, 32^3), the
   ``smoke`` train step (1, 64^3) and the ``unit`` train step (C = 4: C % 8
   != 0), each against its plain version (f32 math, TF32 off): conv forward
   and dgrad, IN+act forward and backward, dgamma/dbeta max|d|/max|ref| <=
   1e-5, down, up and the up backward <= 1e-6 (the up backward also bitwise
   its result on a contiguous copy), the down backward bitwise, a repeat run
   bitwise equal, every launch on ``launches_f32`` and none on a bf16-only
   route (for the conv, the planner's shared-memory bytes equal to the
   kernel's ``conv3d_f32_smem_bytes``), and device time beside the Triton
   form (prev), the bound (f32 bytes, the f32 pipe) and the library call on
   the same f32 inputs; the two resize backwards also at edge shapes (an
   odd extent, a size-1 axis, C 12, a misaligned g). The f32
   instance of ``csrc/winograd3d.cu`` (F3b) at the same f32 conv shapes
   (their first convs have Ci = 4: Ci % 16 != 0): within 1e-5 of max|ref| of
   the plain Winograd and of the direct conv (f32 math, TF32 off), a repeat
   run bitwise equal, every launch on ``conv3d_winograd.launches_f32``, the
   planner's shared-memory bytes equal to the kernel's, device
   time beside its bound (8/27 of the direct conv's products on the f32
   pipe), the FFMA direct conv and cuDNN's f32 conv. The fused f32 routes:
   at every f32 conv shape that an IN follows, the f32 conv's STATS
   epilogue (``conv3d_stats_ndhwc_f32``): y bitwise the plain instance's,
   its partials bitwise repeatable, the merged mean and rstd within 1e-5 of
   y's plain statistics, IN+act from the partials within 1e-5 of the plain
   version and bitwise repeatable, and at the accuracy config's tile batch
   the row's three terms (epilogue, merge, apply) beside the three-launch
   form (``prev_ms``); at every f32 up, the f32 instance of
   ``csrc/resize2x.cu`` written into the decoder's concat buffer in one
   launch: up half within 1e-6 of the plain up (and whether bitwise), skip
   half bitwise, timed against the Triton up made apart and copied into the
   buffer (prev). Then the launch floor: 100 launches of each f32 resize and
   its backward (resize2x.cu, and the Triton form where it has one) at a
   tiny shape replayed from one CUDA graph, in us a launch.
3. The predict slice: CASES synthetic 240x240x155 cases and seeded random
   ``cascade`` weights saved as ``params.npz``, run through
   ``brats2019_tpu_torch.cli.predict`` on the card with the launch counters
   zeroed just before; outputs checked (shape, labels in {0,1,2,4}), every
   forward kernel launched (24 convs per volume, all on the wgmma
   instance with the statistics epilogue, 24 IN+act from its partials, 5
   ups on ``resize2x.cu`` into the concat buffer), ``stage_roi`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no device-to-host wait; the
   same start and tiles), a repeat run bitwise
   equal, the kernel path held against the plain torch path on the CPU at a
   small input, and device ms/volume (CUDA events) and end-to-end s/volume.
4. The training slice: ``brats2019_tpu_torch.cli.train --preset cascade
   --stage all --device cuda`` on the phase-3 cases (2 train, 1 val) for
   TRAIN_STEPS steps per stage, counters zeroed just before; every logged
   loss finite and grad_norm > 0; the three backward kernels launched exactly
   (14 IN, 3 down, 3 up per fine step; 10, 2, 2 per coarse step), the IN and
   up backward all on their CUDA C++ kernels; a rerun
   with more steps resumes; ``cli.predict`` serves the trained workdir. Then
   one train step of the kernel path on the card against the plain path on
   the CPU (bf16 both, same weights and batch, a 64^3 patch), and per stage
   the train step ms (CUDA events after warm-up), patches/s, MFU, peak
   device memory, the kernels' device ms per step against their plain
   versions, and a torch.profiler table of the step's device time.

5. The serving slice: ``brats2019_tpu_torch.cli.serve`` on the phase-3 cases
   and weights at the full ``cascade`` width, in this process (so the launch
   counters are its own) with the conv backend set to ``winograd``:
   ``--warmup --http <free loopback port> --prep-cache DIR --postproc device
   --device cuda``. A client thread waits for ``/healthz`` to say warm, zeroes
   the counters, submits every case at once by ``POST /predict`` with
   ``{"case_dir": ...}``, reads ``/result`` and ``/stats``, and stops the
   daemon with SIGTERM (a clean drain is required). Checked: every request
   answered and logged; 24 ``conv3d_winograd`` launches per volume, all on the
   wgmma instance, and no direct-conv launch, IN/down/up as in phase 3 (the
   IN taking its own statistics: the Winograd conv has no epilogue for
   them); labels in {0,1,2,4} at the
   input's shape; Winograd masks against phase 3's direct-conv masks (voxel
   agreement >= 0.995: both are bf16 paths); a second daemon on the same
   output dir serves nothing (log replay); a daemon with a fresh log
   re-serves the same directories from the payload cache without decoding
   (the cache keys on the case directory and its files' signature, so a copy
   under a new name is a new entry by design); with the direct backend,
   ``--postproc host`` and ``--postproc device`` both give phase 3's masks
   bitwise (pipelining changes nothing; device postprocessing equals host
   scipy on the same labels). Printed: device ms/vol with each backend,
   connected components ms on the ROI on the device and in host scipy, the
   burst's e2e s/vol beside phase 3's serial one, and the device's idle
   share over the burst.

6. The other predict programs, through ``brats2019_tpu_torch.cli.predict
   --device cuda`` with seeded random weights saved as ``params.npz``, the
   counters zeroed just before each run: ``single_chip`` at the flagship fine
   width (no cascade: the staged sweep, 12 tiles of 128^3 at batch 8) on the
   phase-3 cases, ``reference_parity`` (the monolithic program with
   full-resolution TTA; its first level on ``conv3d.cu`` and the
   three-launch IN) and ``cascade --no-tta`` (monolithic, one tile) on one
   case each: labels in {0,1,2,4} at the input's shape, a repeat run bitwise
   equal, launch counts equal to what the program's tiles and nets give, on
   their routes, the program ``make_predict_fn`` chose, the staged sweep on
   the card against the plain path on the CPU at a small input, and device
   ms/volume (CUDA events) and e2e s/volume. It runs after phase 5, so that
   phases 4 and 5 meet the card as they did before it was added.

7. The accuracy slice, after phase 6 so that phases 4-6 meet the card as
   before: (0) the f32 presets ``unit`` and ``smoke`` train 3 steps with an
   eval and predict through the CLIs on the card, every launch on an f32
   route (every up and down backward of the training on ``resize2x.cu``);
   (1) the five arms of the accuracy benchmark (single view, TTA, the
   2-member ensemble, EMA weights, the empty-ET case) at f32 on the card on
   the committed fixtures (``tests/fixtures/accuracy``) and the hard cases of
   seeds 10, 11, 13 at (64, 64, 48) from the port's generator: every bound of
   ``tests/test_accuracy_benchmark.py:108-183`` (restated in
   :func:`accuracy_bounds`), only f32 routes launched (every IN+act from its
   conv's partials, every up into its concat on ``resize2x.cu``, as in part
   (0) on the direct backend), labels equal to the CPU plain path's but on
   ties (the count printed); (2) the flagship ensemble,
   ``cli.predict --preset cascade --ensemble W2 --save-probs
   --save-uncertainty`` on the phase-3 cases with a second seeded random
   member: labels in {0,1,2,4}, probabilities summing to 1 within f16
   rounding, their argmax against the labels before postprocessing, the
   uncertainty maps in [0, 100], a repeat run bitwise equal, the primary as
   its own second member giving the Predictor's probabilities bitwise and
   phase 3's labels, 24 wgmma convs per member per volume per pass; (3)
   ``cli.evaluate --ensemble W2 --hd95 --sens-spec``; (4) one ``serve``
   daemon with ``--ensemble --save-probs --save-uncertainty --http``: POST
   /predict one case, GET its probs and whole-tumour uncertainty artifacts;
   (5) the ensemble's device ms/vol (CUDA events around the members'
   probability programs and the accumulation) for K = 1 and 2, e2e s/vol and
   peak device memory. Part (0) also predicts ``unit`` and ``smoke`` again
   with ``set_backend("winograd")`` (F3b): every conv on the f32 Winograd
   instance, none on the direct conv, labels equal to the direct backend's
   but on ties.

8. The training left-outs at the flagship fine width (``cascade``: 4 levels,
   base 64, max 320, s2d r=2, 128^3 patches, batch 1), after phase 7 so that
   phases 3-7 meet the card as before: (1) ``cli.train --stage fine
   --distill-from T1 T2`` (T1 phase 4's workdir, T2 seeded random weights
   exported through the weight bridge) for KD_STEPS steps with
   ``--prep-cache --debug-checks --profile``, counters zeroed just before:
   kd_loss finite and > 0 and loss = gt + kd within 1e-5 in the log, the
   teachers bitwise unchanged, every launch on the wgmma conv with its
   statistics epilogue / IN from partials / the CUDA C++ up and backwards,
   the trace holding device kernels; one batch's KD loss on the kernel path
   within KD_TOL of the plain path (the CPU, bf16, at STEP_REF_PATCH); the
   KD step's ms (CUDA events, 10 after 3 warm-up) beside the plain fine
   step's in the same process, patches/s, MFU, peak memory and a profile
   (device kernel time, idle share); (2) one deep-supervision fine step at
   ``remat_levels`` 0 and 2 on the same batch: losses bitwise equal, grads
   within REMAT_GRAD_TOL (and whether bitwise), the recomputed levels'
   forward kernels launched twice, peak memory and ms of each; (3)
   ``--init-from`` an ``.npz``, a ``.safetensors`` and a ``.pt`` with
   foreign key names: step-0 params equal the file's, the pool read from
   the prep cache (no NIfTI decode) equal to the first run's; a second run
   resumes and prints the IGNORED note; ``cli.import_torch`` of a foreign
   ``reference_parity`` ``.pt`` (the importer refuses space-to-depth
   presets), then ``cli.predict --profile`` of one phase-3 case from it on
   the card; (4) ``cli.info`` reports the card.

9. Queue 1 items 6a, 7a and 5, after phase 8 so that phases 3-8 meet the
   card as before: (1) the native NIfTI decoder
   (``utils/nifti_fast.py``): built and loaded (it fails, rather than
   falling back, when it is not), its volumes, labels and header bitwise the
   NumPy reader's and its fused bbox the scan's on the phase-3 cases; phase
   3's one-by-one e2e and the phase-5 burst (Winograd, fresh payload cache,
   device postprocessing) with and without it, in turns, in this call;
   (2) ``unit`` trained on the card with ``--ema-decay``, ``cli.export
   --ema`` and ``--average 2``: the exported tensors equal the tracker's and
   the mean of the last two retained steps, and ``cli.predict`` loads each;
   (3) the three ``--multichip`` modes of ``infer/multichip.py`` on the
   flagship ``cascade`` preset at full width over meshes of 2 and 4 shards of
   the card: each shard's IN statistics pass merged over the shards within
   2 bf16 ulp of the whole volume's plain IN+act at the fine net's top
   level; ``cascade`` labels (postprocessing off) equal the single-device
   predictor's except on ties (top-2 gap <= TIE_GAP) and, postprocessed,
   phase 3's masks; ``sweep`` labels equal the single-stage predictor's
   except on ties; ``spatial`` logits within SPATIAL_TOL of the one-shard
   spatial route and of the unsharded model's whole-canvas forward, and at
   f32 compute within SPATIAL_F32_TOL of the unsharded f32 forward; the
   launch counters of each mode equal to every
   conv, IN (with, in ``spatial``, each shard's statistics pass), up (into
   its concat, on ``resize2x.cu``) and down of every shard, every conv on
   the wgmma instance; device ms/vol of each mode; one ``serve --multichip
   cascade --device cuda:0,cuda:0`` burst on the Winograd backend; (4)
   ``make_spatial_train_grad`` on the fine net at full width over 2 shards
   of the card: in f32 its grads against the unsharded model's on the same
   volume (relative L2 within SPATIAL_GRAD_TOL), in f32 and bf16 every conv,
   IN backward, up and down backward of every shard counted on its kernel;
   the fine stage at full width data-parallel over 2 shards of the card: the
   averaged grads in f32 compute against the mean of each shard's one-shard
   grads (DP_SHARD_TOL) and against the one-shard step on the concatenated
   batch (DP_GRAD_TOL), finite bf16 losses, step ms; (5) ``parallel/
   multiprocess.py``: ``launch_workers`` with one worker over NCCL, then two
   workers sharing the card over gloo against one process of two shards
   (losses within MP_LOSS_RTOL, the cascade mask equal), no worker importing
   jax or the JAX package.

10. Queue 1 items 6b and 5b, after phase 9 so that phases 3-9 meet the card
   as before: (1) volume pairing (``batch_volumes=2``) on the flagship
   ``cascade`` at full width on the phase-3 cases (one pair and an odd
   tail): labels with postprocessing off equal the single-volume
   predictor's except on ties (top-2 gap <= TIE_GAP), postprocessed masks
   agree with phase 3's at >= MESH_MASK_AGREE; the launch counters of one
   pair (two ``stage_roi``, one fine forward at batch 16): every conv on the
   wgmma instance with the STATS epilogue, every IN from its partials, every
   up into its concat; rows 1, 2 and 6 against their plain versions at the
   batch-16 top-level shapes (the concat buffer 16 x 64^3 x 192 holds 805 M
   elements: the index-width check); device ms/vol of one pair against two
   single volumes, in turns; (2) the int8 transfer encoding: masks against
   phase 3's bf16 masks (> INT8_AGREE, the JAX package's bar), the payload's
   host-to-device bytes of both encodings (int8 half of bf16) and the copy's
   device time, an int8 payload-cache hit (no decode) equal to the miss,
   one-by-one e2e and the host encode in turns; ``serve`` bursts of
   BURST_CASES cases (the phase-3 cases under new names; one chunk, 4 pairs
   with pairing) on the Winograd backend with ``--batch-volumes 1``,
   ``--batch-volumes 2`` and ``--transfer-dtype int8``, BURST_TURNS rounds
   in turns: each arm's s/vol and device idle share (the CUDA-event edges
   of the program's ``predict.program`` spans), median and spread; (3)
   ``serve --supervise --rss-limit-mb RSS_LIMIT_MB`` as a process on the
   card with a burst of the phase-3 cases: each answered once in the
   completion log, at least one exit-4 recycle, SIGTERM stops the
   supervisor with exit code 0; (4) a KD
   step of ``unit`` (f32, 2 teachers) over the mesh ``cuda:0, cpu`` (one
   card gives one distinct CUDA device): each shard's teacher replicas on its
   device, losses and grads within DP_GRAD_TOL of the step over ``cpu,
   cpu``, the card shard's IN, up and down backwards counted on their
   kernels; then ``train_stage`` with the teachers over that mesh, 2 steps.

11. The program export (``infer/export_hlo.py``), after phase 10 so that
   phases 3-10 meet the card as before, on phase 3's weights and cases: (1)
   ``cli.export --preset cascade --stablehlo --stablehlo-check`` on the card
   (from checkpoints holding phase 3's weights): exit code 0, a manifest of
   ``stage_roi`` and ``stage_fine``, checked, on the card (its name and SM
   count recorded), the direct backend; every ``.pt2`` without a parameter or buffer input and without
   an aten convolution (its bytes printed); for each phase-3 case canvas the
   exported program's labels and start (``run_exported``) bitwise the eager
   split cascade's; the launches of one exported volume by route (conv on
   the wgmma instance with the statistics epilogue, IN from partials, up
   into the concat, down, the connected components) equal to the eager
   volume's and to what the nets give; (2) the same for serve's program, the
   Winograd backend with ``postproc="device"`` (its connected components one
   ``brats_torch::label_components`` node in the program); (3) the same for
   one ``predict.pt2``, ``cascade --no-tta`` (the monolithic program); device
   ms/vol of each exported program and of the eager one, in turns (nothing is
   claimed).

12. The device connected components on the whole canvas, after phase 11:
   the ``single_chip`` program (seeded random weights, the benchmark's
   cohort program) predicts the phase-3 cases; on each canvas's foreground
   mask (192, 224, 160) the kernel (``csrc/connected_components.cu``) gives
   the plain form's ids bitwise (the plain form run on the card, its pooling
   passes and jump rounds printed; the record's ``max_abs_err`` is the
   largest id difference). Timed in turns (plain, kernel, kernel, plain):
   the kernel by CUDA events over ``CC_REPLAYS`` replays of one CUDA graph
   (``ms``) and eagerly (``wall_ms``), the plain form by CUDA events, its
   flag reads included (``plain_ms``), and by the host clock around a
   synchronised call (``plain_wall_ms``), host scipy's ``ndimage.label`` on
   the same mask as the yardstick; the program with ``postproc="device"``
   counts one ``label_components`` call a volume (the record's
   ``launches``, over the phase-3 cases); then that whole program, device
   ms/vol, with the kernel and with the plain form in its place, in turns.
   Its row joins the kernel record.

13. The Swin UNETR's window attention (``csrc/window_attention.cu``), after
   phase 12: at the four stages of a 128^3 tile at batch 8 (the padded grids
   70^3, 35^3, 21^3, 14^3; 3, 6, 12, 24 heads), shifted and not, the kernel
   against the plain form (f32 math on the same bf16 qkv, the table at unit
   scale): max error within 2e-2 of the largest output and mean error
   within 4e-3 of the mean output, a repeat bitwise, one call and one kernel
   launch a call; device ms by CUDA-graph replay beside the plain form,
   ``F.scaled_dot_product_attention`` with B + M materialised and the bound;
   then the Swin Predictor (``perfbench/configs/swin_unetr.json``, seeded
   weights) on two synthetic cases with the counters set to 0 just before:
   96 calls and 96 kernel launches a volume. Its row (per batch-8 forward)
   joins the kernel record.

The line before the last holds the kernels' JSON record (forward kernels:
launches on the predict slice, times per volume; backward kernels: launches
on the training slice, times per fine train step; the Winograd conv:
launches on the serving slice, times per volume; the connected components:
calls on phase 12's canvases, times per volume; the window attention:
launches on phase 13's Swin predictor run, times per batch-8 forward; the f32 instances
(``*_f32``): forward launches on phase 7's accuracy arms (the f32 Winograd:
on its Winograd-backend predicts), times per
accuracy-config tile batch, backward launches on phase 7's ``smoke``
training, times per smoke train step; ``ms``/``plain_ms``/
``library_ms``/``bound_ms`` are device times, ``wall_ms``/``plain_wall_ms``
back-to-back wall times); the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits 1 before doing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# where the profiler tables go (set CHIP_SMOKE_OUT to collect them elsewhere)
OUT = os.environ.get("CHIP_SMOKE_OUT", os.path.join(ROOT, "build", "profiles"))
PRESET, DEVICE = "cascade", "cuda"   # what phase 5's daemons are started with
CASES = 3   # synthetic 240x240x155 requests
ACC_SHAPE = (64, 64, 48)   # the accuracy benchmark's cases and canvas
SEED = 0    # of the cases and of the random weights
TRAIN_STEPS = 20   # per stage; log every 5, eval and checkpoint every 10
# the one-step check of the kernel train step against the plain path: its
# input, and bounds set from the readings at that size on an H100 (PERF.md:
# loss rel <= 5.6e-6; per-parameter card/CPU-bf16 distance ratio <= 1.17
# where the distance exceeds 0.01; 1.004 and 0.992 over all grads)
STEP_REF_PATCH = (64, 64, 64)
LOSS_TOL = 1e-4
GRAD_FACTOR, GRAD_FACTOR_ALL, GRAD_ABS = 1.3, 1.1, 2e-3

KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    # the wgmma instance runs every conv of the three slices; conv3d.cu is the
    # general instance (Ci % 16 or Co % 8 nonzero), timed beside it as prev_ms
    "conv3d": ("cuda", "brats2019_tpu_torch/csrc/conv3d_wgmma.cu",
               "brats2019_tpu/ops/pallas_conv.py:79"),
    # statistics from the conv's epilogue (csrc/conv3d_wgmma.cu, STATS), then
    # the Triton merge and apply; the three-launch forward is timed as prev_ms
    "instance_norm_act": ("triton", "brats2019_tpu_torch/ops/triton_norm.py",
                          "brats2019_tpu/ops/pallas_norm.py:176"),
    "downsample2x": ("triton", "brats2019_tpu_torch/ops/triton_resize.py",
                     "brats2019_tpu/ops/pallas_resize.py:268"),
    # the Triton _up2x_kernel stays for C % 8 != 0, timed as prev_ms
    "upsample2x": ("cuda", "brats2019_tpu_torch/csrc/resize2x.cu",
                   "brats2019_tpu/ops/pallas_resize.py:103"),
    # one persistent launch (csrc/in_act_bwd.cu); the Triton kernels stay for
    # C % 8 != 0 and are timed beside it as prev_ms
    "instance_norm_act_bwd": ("cuda", "brats2019_tpu_torch/csrc/in_act_bwd.cu",
                              "brats2019_tpu/ops/pallas_norm.py:265"),
    "downsample2x_bwd": ("triton", "brats2019_tpu_torch/ops/triton_resize.py",
                         "brats2019_tpu/ops/pallas_resize.py:304"),
    # read in place from the concat gradient; the Triton kernel (after the
    # copy of the up half it needed) is timed beside it as prev_ms
    "upsample2x_bwd": ("cuda", "brats2019_tpu_torch/csrc/resize2x.cu",
                       "brats2019_tpu/ops/pallas_resize.py:213"),
    # likewise: winograd3d.cu is the general instance, timed as prev_ms
    "conv3d_winograd": ("cuda", "brats2019_tpu_torch/csrc/winograd3d_wgmma.cu",
                        "brats2019_tpu/ops/pallas_winograd.py:181"),
}
# shapes off the three slices that the planner sends to the general instance
# (csrc/conv3d.cu): Ci % 16 != 0 (four raw modalities), Co % 8 != 0, both,
# ragged against its 128-row tile
GENERAL_CONV_CALLS = [("conv3d", (1, 24, 28, 20, 4, 32)),
                      ("conv3d", (1, 12, 14, 10, 48, 4)),
                      ("conv3d", (2, 9, 7, 13, 40, 20))]
# the same through the Winograd seam (``winograd3d.cu``, its general instance):
# the Winograd conv needs even D, H, W, so the third shape is an even one
GENERAL_WINO_CALLS = [("conv3d_winograd", (1, 24, 28, 20, 4, 32)),
                      ("conv3d_winograd", (1, 12, 14, 10, 48, 4)),
                      ("conv3d_winograd", (2, 10, 8, 14, 40, 20))]
# edge shapes of the two backward kernels (forward input shapes): C = 48, an
# odd extent, a size-1 axis, C = 48 with part of x and g held; C = 12 goes to
# the Triton kernels by plan
BWD_EDGE_CALLS = [("instance_norm_act_bwd", (1, 9, 7, 11, 48)),
                  ("instance_norm_act_bwd", (1, 64, 64, 64, 48)),   # part held
                  ("instance_norm_act_bwd", (1, 1, 4, 1, 64)),
                  ("instance_norm_act_bwd", (2, 5, 6, 7, 12)),
                  ("upsample2x_bwd", (1, 5, 3, 9, 48)),
                  ("upsample2x_bwd", (1, 1, 7, 1, 64)),
                  ("upsample2x_bwd", (1, 4, 4, 4, 12))]
EPILOGUE_SOURCE = "brats2019_tpu_torch/csrc/conv3d_wgmma.cu"   # row 2's statistics
# the tree's earlier kernel of a row, timed beside it in the same run
PREV_SOURCE = {
    "conv3d": "brats2019_tpu_torch/csrc/conv3d.cu",
    "conv3d_winograd": "brats2019_tpu_torch/csrc/winograd3d.cu",
    "upsample2x": "brats2019_tpu_torch/ops/triton_resize.py",
    "instance_norm_act_bwd": "brats2019_tpu_torch/ops/triton_norm.py (three launches)",
    "upsample2x_bwd": "brats2019_tpu_torch/ops/triton_resize.py (after a copy of "
                      "the concat gradient's up half)",
}
FORWARD = ("conv3d", "instance_norm_act", "downsample2x", "upsample2x")
BACKWARD = ("instance_norm_act_bwd", "downsample2x_bwd", "upsample2x_bwd")
WINO_TOL = 2e-2        # Winograd kernel vs its plain version, max|d|/max|ref|
MASK_AGREE = 0.995     # Winograd-backend masks vs direct-backend masks
# published peaks of one H100 SXM: dense bf16 and f32 FLOP/s, HBM bytes/s
PEAK_BF16, PEAK_F32, PEAK_BW = 989e12, 67e12, 3.35e12
FAILURES: list = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ shapes --

def unet_calls(cfg, batch, spatial):
    """The (kernel, shape) calls one forward of ``cfg`` makes, in order:
    conv (N, D, H, W, Ci, Co); norm/down/up (N, D, H, W, C)."""
    r = cfg.stem_downsample
    s = tuple(v // r for v in spatial)
    c = cfg.in_channels * r ** 3
    calls = []

    def block(c_in, f):
        calls.extend([("conv3d", (batch, *s, c_in, f)),
                      ("instance_norm_act", (batch, *s, f)),
                      ("conv3d", (batch, *s, f, f)),
                      ("instance_norm_act", (batch, *s, f))])

    for lvl in range(cfg.levels):
        block(c, cfg.feats(lvl))
        c = cfg.feats(lvl)
        if lvl < cfg.levels - 1:
            calls.append(("downsample2x", (batch, *s, c)))
            s = tuple(v // 2 for v in s)
    for lvl in reversed(range(cfg.levels - 1)):
        calls.append(("upsample2x", (batch, *s, c)))
        s = tuple(v * 2 for v in s)
        block(c + cfg.feats(lvl), cfg.feats(lvl))
        c = cfg.feats(lvl)
    return calls


def train_calls(cfg, batch, spatial):
    """The calls of one train step: the forward's, then the backward's in
    reverse order (IN, down and up backward at their forward input's shape;
    conv dgrad as the conv kernel with Ci and Co swapped, none for the
    stem's first conv)."""
    fwd = unet_calls(cfg, batch, spatial)
    bwd = []
    for i, (name, shape) in enumerate(fwd):
        if name != "conv3d":
            bwd.append((name + "_bwd", shape))
        elif i > 0:
            bwd.append(("conv3d", shape[:4] + (shape[5], shape[4])))
    return fwd + bwd[::-1]


# ------------------------------------------------------------------ phase 2 --

def bf16_ulps(got, ref):
    """Largest |got - ref| in units of bf16 spacing at |ref| (magnitudes
    below 2^-10 use the spacing at 2^-10)."""
    import torch

    ref32 = ref.float()
    mag = ref32.abs().clamp_min(2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - ref32).abs() / ulp).max().item()


def cuda_ms(fn, reps: int) -> float:
    """Wall time per call of back-to-back calls (CUDA events): for a small
    call this is the wrapper's host launch cost, not the card's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph
    (after a warm-up call on a side stream), timed by CUDA events around a
    replay, so no host launch cost sits between the kernels. (On an H100,
    per-call torch.profiler sessions read up to a third below the wall time
    of a 9 ms kernel in one run and not in another, so they are not used
    here.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_terms(name, shape, itemsize=2):
    """The two terms of a call's bound in ms: the bytes it must move (every
    input read once, every output written once, ``itemsize`` bytes an element:
    2 for bf16, 4 for f32) over the card's memory rate, and its operations
    over the card's peak for their type (bf16 tensor cores for the bf16
    convs' products, the f32 pipe for the f32 convs and everything else).
    The Winograd conv counts its 64 per-point products per 2^3 outputs (8/27
    of the direct conv's)."""
    if name in ("conv3d", "conv3d_winograd"):
        n, d, h, w, ci, co = shape
        m = n * d * h * w
        macs = (27 if name == "conv3d" else 8) * ci * co * m
        nbytes = itemsize * (m * ci + 27 * ci * co + m * co)
        peak = PEAK_BF16 if itemsize == 2 else PEAK_F32
        return nbytes / PEAK_BW * 1e3, 2 * macs / peak * 1e3
    numel = math.prod(shape) * itemsize / 2   # the forward input, in bf16 elements
    nbytes, flops = {
        "instance_norm_act": (4 * numel, 8 * numel),
        "instance_norm_act_bwd": (6 * numel, 14 * numel),
        "downsample2x": (2.25 * numel, numel),
        "downsample2x_bwd": (2.25 * numel, numel),
        "upsample2x": (18 * numel, 8 * 15 * numel),
        "upsample2x_bwd": (18 * numel, 8 * 15 * numel),
    }[name]
    return nbytes / PEAK_BW * 1e3, flops * 2 / itemsize / PEAK_F32 * 1e3


def library_ms(name, x, reps, gy=None, wt=None, gam=None, bet=None):
    """Device ms of the one PyTorch call that computes the kernel's function
    on the same bf16 inputs (NDHWC memory seen as channels_last_3d NCDHW). A
    backward kernel is held against that call's autograd backward, read as
    (forward + backward) - forward, both replayed from a CUDA graph. Used
    nowhere in the port."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)
    base = name[:-4] if name.endswith("_bwd") else name
    if base in ("conv3d", "conv3d_winograd"):
        wc = wt.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        fwd = lambda t: F.conv3d(t, wc, padding=1)
        params = ()
    elif base == "instance_norm_act":
        g_c = gam.to(x.dtype).requires_grad_(name.endswith("_bwd"))
        b_c = bet.to(x.dtype).requires_grad_(name.endswith("_bwd"))
        fwd = lambda t: F.relu(F.instance_norm(t, weight=g_c, bias=b_c, eps=1e-5))
        params = (g_c, b_c)
    elif base == "downsample2x":
        fwd = lambda t: F.avg_pool3d(t, 2)
        params = ()
    else:
        fwd = lambda t: F.interpolate(t, scale_factor=2, mode="trilinear",
                                      align_corners=False)
        params = ()
    if not name.endswith("_bwd"):
        with torch.no_grad():
            return device_ms(lambda: fwd(xc), reps)
    xr = xc.detach().requires_grad_()
    gc = gy.permute(0, 4, 1, 2, 3)
    both = device_ms(
        lambda: torch.autograd.grad(fwd(xr), (xr,) + params, gc), reps)
    with torch.no_grad():
        only_fwd = device_ms(lambda: fwd(xc), reps)
    return both - only_fwd


def check_kernels(calls, dev, library_for=(), up_skips=None):
    """Each unique (kernel, shape) once: error against the plain version,
    then the device time of both (CUDA graph) and their back-to-back wall time
    (CUDA events); for the calls in ``library_for`` also the one PyTorch
    call that computes the same function. Returns {(name, shape): (err,
    max_abs_err, ms, plain_ms, wall_ms, plain_wall_ms, bytes-bound ms,
    operations-bound ms, library_ms or None, prev_ms or None: the tree's
    earlier kernel on the same inputs)}. ``up_skips`` maps an up backward's
    shape to the skip channels of its concat gradient (8 where absent)."""
    import torch

    from brats2019_tpu_torch.ops import conv, norm, resize, winograd

    library_for = set(library_for)
    up_skips = up_skips or {}
    conv_library = {}

    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, shape in dict.fromkeys(calls):
        gy = wt = gam = bet = None
        if name in ("conv3d", "conv3d_winograd"):
            n, d, h, w, ci, co = shape
            x = torch.randn((n, d, h, w, ci), generator=g, device=dev).bfloat16()
            wt = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev)
                  / (27 * ci) ** 0.5).bfloat16()
            if name == "conv3d":
                kern = lambda: conv.conv3d_kernel(x, wt)
                plain = lambda: conv.conv3d_plain(x, wt)
                plan = conv.plan_conv(*shape)
            else:
                kern = lambda: winograd.conv3d_winograd_kernel(x, wt)
                plain = lambda: winograd.conv3d_winograd_plain(x, wt)
                plan = winograd.plan_winograd(*shape)
        elif name == "instance_norm_act":
            x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
            gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
            bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
            kern = lambda: norm.instance_norm_act_kernel(x, gam, bet)[0]
            plain = lambda: norm.instance_norm_act_plain(x, gam, bet)
        elif name == "instance_norm_act_bwd":
            x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
            gy = torch.randn(shape, generator=g, device=dev).bfloat16()
            gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
            bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
            _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
            args = (x, gy, gam, bet, mean, rstd)
            kern = lambda: norm.instance_norm_act_bwd_kernel(*args)
            plain = lambda: norm.instance_norm_act_bwd_plain(*args)
            triton_bwd = lambda: norm.instance_norm_act_bwd_kernel_triton(*args)
        elif name == "downsample2x_bwd":
            gy = torch.randn((shape[0],) + tuple(v // 2 for v in shape[1:4])
                             + shape[4:], generator=g, device=dev).bfloat16()
            kern = lambda: resize.downsample2x_bwd_kernel(gy, shape)
            plain = lambda: resize.downsample2x_bwd_plain(gy, shape)
        elif name == "upsample2x_bwd":
            # the up half of the decoder's concat gradient, read in place
            cs = up_skips.get(shape, 8)
            cat = torch.randn((shape[0],) + tuple(2 * v for v in shape[1:4])
                              + (shape[4] + cs,), generator=g,
                              device=dev).bfloat16()
            gy = cat[..., :shape[4]]
            kern = lambda: resize.upsample2x_bwd_kernel(gy)
            plain = lambda: resize.upsample2x_bwd_plain(gy)
        else:
            x = torch.randn(shape, generator=g, device=dev).bfloat16()
            kfn = getattr(resize, f"{name}_kernel")
            pfn = getattr(resize, f"{name}_plain")
            kern = lambda: kfn(x)
            plain = lambda: pfn(x)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        extra = ""
        if name == "instance_norm_act_bwd":
            rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
            sums_err = max(rel(got[1], ref[1]), rel(got[2], ref[2]))
            extra = f", dgamma/dbeta {sums_err:.3e} (tol 1e-3)"
            sums, ref_sums = got[1:], ref[1:]
            got, ref = got[0], ref[0]
        abs_err = (got.float() - ref.float()).abs().max().item()
        if name == "conv3d_winograd":
            err = abs_err / ref.float().abs().max().item()
            wino = winograd.conv3d_winograd
            before = (wino.launches, wino.launches_wgmma)
            again = kern()
            torch.cuda.synchronize()
            took = (wino.launches - before[0], wino.launches_wgmma - before[1])
            same = bool((again == got).all())
            direct = conv.conv3d_kernel(x, wt).float()
            d_err = ((direct - ref.float()).abs().max()
                     / ref.float().abs().max()).item()
            # the planner's rule, and the instance the launch really took
            want = "mma_sync" if shape[4] % 16 or shape[5] % 8 else "wgmma"
            ok = (err <= WINO_TOL and same and plan.instance == want
                  and took == (1, int(want == "wgmma"))
                  and plan.smem_bytes <= winograd.SMEM_LIMIT)
            what = (f"max|d|/max|ref| {err:.3e} (tol {WINO_TOL:g}; the direct "
                    f"kernel against the same reference {d_err:.3e}), repeat "
                    f"run bitwise equal: {same}, instance {plan.instance} brick "
                    f"{'x'.join(map(str, plan.brick))} tiles ({plan.grid} (brick, "
                    f"Co tile) pairs on {plan.blocks} blocks, fill "
                    f"{plan.fill:.2f}, {plan.smem_bytes} B shared)")
            if want == "wgmma":
                # the general instance (csrc/winograd3d.cu) on the same inputs,
                # held to the same reference before it is timed as prev_ms
                old = winograd.conv3d_winograd_kernel_mma_sync(x, wt)
                torch.cuda.synchronize()
                p_err = ((old.float() - ref.float()).abs().max()
                         / ref.float().abs().max()).item()
                ok = ok and p_err <= WINO_TOL and old.shape == ref.shape
                what += f"; mma.sync kernel (prev) {p_err:.3e} (tol {WINO_TOL:g})"
                del old
            del again, direct
        elif name == "conv3d":
            err = abs_err / ref.float().abs().max().item()
            before = (conv.conv3d.launches, conv.conv3d.launches_wgmma)
            again = kern()
            torch.cuda.synchronize()
            took = (conv.conv3d.launches - before[0],
                    conv.conv3d.launches_wgmma - before[1])
            same = bool((again == got).all())
            # the planner's rule, and the instance the launch really took
            want = "mma_sync" if shape[4] % 16 or shape[5] % 8 else "wgmma"
            ok = (err <= 1e-2 and same and plan.instance == want
                  and took == (1, int(want == "wgmma"))
                  and plan.smem_bytes <= conv.SMEM_LIMIT)
            what = (f"max|d|/max|ref| {err:.3e} (tol 1e-2), repeat run bitwise "
                    f"equal: {same}, instance {plan.instance} box "
                    f"{'x'.join(map(str, plan.box))} Co tile {plan.bn} "
                    f"({plan.grid} tiles, {plan.smem_bytes} B shared)")
            if want == "wgmma":
                # the general instance (csrc/conv3d.cu) on the same inputs,
                # held to the same reference before it is timed as prev_ms
                old = conv.conv3d_kernel_mma_sync(x, wt)
                torch.cuda.synchronize()
                p_err = ((old.float() - ref.float()).abs().max()
                         / ref.float().abs().max()).item()
                ok = ok and p_err <= 1e-2 and old.shape == ref.shape
                what += f"; mma.sync kernel (prev) {p_err:.3e} (tol 1e-2)"
                del old
            del again
        elif name == "instance_norm_act_bwd":
            # in_act_bwd.cu where C % 8 == 0, the Triton kernels by plan else;
            # the Triton kernels held to the same before timed as prev_ms
            err = abs_err / ref.float().abs().max().item()
            before = norm.instance_norm_act_bwd.launches_cuda
            again = kern()
            old = triton_bwd()
            torch.cuda.synchronize()
            on_cuda = norm.instance_norm_act_bwd.launches_cuda - before
            same = all(torch.equal(a, b) for a, b in zip(again, (got, *sums)))
            rel = lambda a, b: ((a.float() - b.float()).abs().max()
                                / b.float().abs().max()).item()
            p_err = rel(old[0], ref)
            p_sums = max(rel(old[1], ref_sums[0]), rel(old[2], ref_sums[1]))
            ok = (err <= 1e-2 and sums_err <= 1e-3 and same and p_err <= 1e-2
                  and p_sums <= 1e-3 and on_cuda == int(shape[-1] % 8 == 0))
            what = (f"max|d|/max|ref| {err:.3e} (tol 1e-2){extra}, repeat run "
                    f"bitwise equal: {same}, {on_cuda} launch on in_act_bwd.cu; "
                    f"Triton kernels (prev) {p_err:.3e}, dgamma/dbeta "
                    f"{p_sums:.3e}")
            del again, old
        elif name == "upsample2x_bwd":
            # resize2x.cu reading the concat gradient in place where C and the
            # pitch are multiples of 8; the Triton kernel held to the same
            err = bf16_ulps(got, ref)
            before = resize.upsample2x_bwd.launches_cuda
            again = kern()
            contig = resize.upsample2x_bwd_kernel(gy.contiguous())
            old = resize.upsample2x_bwd_kernel_triton(gy)
            torch.cuda.synchronize()
            on_cuda = resize.upsample2x_bwd.launches_cuda - before
            same = bool(torch.equal(again, got) and torch.equal(contig, got))
            p_err = bf16_ulps(old, ref)
            ok = (err <= 1 and p_err <= 1 and same
                  and on_cuda == 2 * int(shape[-1] % 8 == 0))
            what = (f"{err:.2f} bf16 ulp (tol 1) from a concat gradient of "
                    f"{gy.shape[-1] + cs} channels, repeat run and contiguous "
                    f"copy bitwise equal: {same}, {on_cuda} launches on "
                    f"resize2x.cu; Triton kernel (prev) {p_err:.2f} ulp (tol 1)")
            del again, contig, old
        elif name == "instance_norm_act":
            err = bf16_ulps(got, ref)
            again = kern()
            torch.cuda.synchronize()
            same = bool((again == got).all())
            ok = err <= 2 and same
            what = (f"{err:.2f} bf16 ulp (tol 2), repeat run bitwise equal: "
                    f"{same}")
            del again
        elif name == "upsample2x":
            # resize2x.cu; the Triton kernel held to the same before it is
            # timed as prev_ms
            err = bf16_ulps(got, ref)
            before = resize.upsample2x.launches_cuda
            again = kern()
            old = resize.upsample2x_kernel_triton(x)
            torch.cuda.synchronize()
            same = bool((again == got).all())
            p_err = bf16_ulps(old, ref)
            on_cuda = resize.upsample2x.launches_cuda - before
            ok = err <= 1 and p_err <= 1 and same and on_cuda == 1
            what = (f"{err:.2f} bf16 ulp (tol 1), repeat run bitwise equal: "
                    f"{same}, {on_cuda} launch on resize2x.cu; Triton kernel "
                    f"(prev) {p_err:.2f} ulp (tol 1)")
            del again, old
        else:
            err = bf16_ulps(got, ref)
            ok = err <= 1
            what = f"{err:.2f} bf16 ulp (tol 1)"
        finite = bool(torch.isfinite(got.float()).all())
        reps = 3 if got.numel() > 1e8 else 10
        preps = 3 if name == "conv3d_winograd" else reps   # a heavy plain version
        wall, plain_wall = cuda_ms(kern, reps), cuda_ms(plain, preps)
        ms, plain_ms = device_ms(kern, reps), device_ms(plain, preps)
        bytes_ms, ops_ms = bound_terms(name, shape)
        lib = prev = None
        if name == "conv3d":
            # the mma.sync kernel on the same inputs, in the same call (where
            # the planner chose it, it is the kernel timed above)
            prev = (ms if plan.instance == "mma_sync" else
                    device_ms(lambda: conv.conv3d_kernel_mma_sync(x, wt), reps))
            tflops = 2 * 27 * math.prod(shape) / ms / 1e9
            extra = (f"; mma.sync kernel (prev) {prev:.4f} ms; {tflops:.0f} "
                     f"TFLOP/s = {100 * tflops * 1e12 / PEAK_BF16:.1f}% of "
                     f"{PEAK_BF16 / 1e12:.0f}; {plan.flop_per_filled_byte:.0f} "
                     f"flop per filled byte")
        elif name == "instance_norm_act":
            # the bytes the bound counts (x read once, y written once)
            extra = (f"; {4 * math.prod(shape) / ms / 1e9:.3f} TB/s of counted "
                     f"bytes ({100 * bytes_ms / ms:.0f}% of "
                     f"{PEAK_BW / 1e12:.2f})")
        elif name == "upsample2x":
            prev = device_ms(lambda: resize.upsample2x_kernel_triton(x), reps)
            extra = f"; Triton kernel (prev) {prev:.4f} ms"
        elif name == "instance_norm_act_bwd":
            prev = device_ms(triton_bwd, reps)
            extra = f"; Triton kernels (prev) {prev:.4f} ms"
        elif name == "upsample2x_bwd":
            prev = device_ms(lambda: resize.upsample2x_bwd_kernel_triton(gy), reps)
            extra = (f"; Triton kernel after the copy of the up half (prev) "
                     f"{prev:.4f} ms")
        elif name == "conv3d_winograd":
            prev = (ms if plan.instance == "mma_sync" else device_ms(
                lambda: winograd.conv3d_winograd_kernel_mma_sync(x, wt), reps))
            tflops = 2 * 8 * math.prod(shape) / ms / 1e9   # the 64 products
            extra = (f"; mma.sync kernel (prev) {prev:.4f} ms; products "
                     f"{tflops:.0f} TFLOP/s = "
                     f"{100 * tflops * 1e12 / PEAK_BF16:.1f}% of "
                     f"{PEAK_BF16 / 1e12:.0f}")
        if (name, shape) in library_for:
            if name in ("conv3d", "conv3d_winograd"):
                if shape not in conv_library:
                    conv_library[shape] = library_ms(name, x, reps, wt=wt)
                lib = conv_library[shape]
            else:
                if name.endswith("_bwd") and name != "instance_norm_act_bwd":
                    x = torch.randn(shape, generator=g, device=dev).bfloat16()
                lib = library_ms(name, x, reps, gy=gy, gam=gam, bet=bet)
        check(ok and finite and got.shape == ref.shape,
              f"{name} {shape}: {what}, max|d| {abs_err:.3e}; device "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; wall "
              f"kernel {wall:.4f} ms, plain {plain_wall:.4f} ms; bound "
              f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f})"
              + ("" if lib is None else f"; library call {lib:.4f} ms")
              + (extra if name in ("conv3d", "conv3d_winograd",
                                   "instance_norm_act", "upsample2x",
                                   "instance_norm_act_bwd", "upsample2x_bwd")
                 else ""))
        results[(name, shape)] = (err, abs_err, ms, plain_ms, wall, plain_wall,
                                  bytes_ms, ops_ms, lib, prev)
        del got, ref, kern, plain
    return results


def conv_norm_shapes(calls):
    """The shape of each conv of ``calls`` that an IN+act follows (the
    ConvNormAct blocks: the conv gives the norm its statistics)."""
    return [sh for (name, sh), (nxt, _) in zip(calls, calls[1:])
            if name == "conv3d" and nxt == "instance_norm_act"]


def check_norm_partials(shapes, dev, timed=()):
    """Row 2's route at every conv shape in ``shapes`` (phase 2 in the module
    docstring); for the shapes in ``timed`` also its three terms and the
    three-launch forward on the same y. Returns {conv shape: dict}."""
    import torch

    from brats2019_tpu_torch.ops import conv, norm, triton_norm

    g = torch.Generator(device=dev).manual_seed(5)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    out = {}
    for shape in dict.fromkeys(shapes):
        n, d, h, w, ci, co = shape
        x = torch.randn((n, d, h, w, ci), generator=g, device=dev).bfloat16()
        wt = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev)
              / (27 * ci) ** 0.5).bfloat16()
        gam = torch.rand(co, generator=g, device=dev) + 0.5
        bet = torch.randn(co, generator=g, device=dev) * 0.2
        before = conv.conv3d.launches_stats
        y0 = conv.conv3d_kernel(x, wt)
        y, part = conv.conv3d_kernel(x, wt, stats=True)
        _, part2 = conv.conv3d_kernel(x, wt, stats=True)
        mean, rstd = triton_norm.merge(part, 1e-5)
        _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
        with_part = lambda: norm.instance_norm_act_kernel(y, gam, bet,
                                                          partials=part)[0]
        got, again = with_part(), with_part()
        ref = norm.instance_norm_act_plain(y, gam, bet)
        torch.cuda.synchronize()
        same = (bool(torch.equal(y, y0)), bool(torch.equal(part, part2)),
                bool(torch.equal(got, again)))
        stats_err = max(rel(mean, rmean), rel(rstd, rrstd))
        err = bf16_ulps(got, ref)
        rec = {"err": err, "abs_err": (got.float() - ref.float()).abs().max().item()}
        ok = (all(same) and stats_err <= 1e-5 and err <= 2
              and conv.conv3d.launches_stats - before == 2)
        what = ""
        if shape in timed:
            n_, d_, h_, w_, c_ = y.shape
            y3 = y.view(n_, d_ * h_ * w_, c_)
            o3 = torch.empty_like(y3)
            reps = 3 if y.numel() > 1e8 else 10
            plain_conv = lambda: conv.conv3d_kernel(x, wt)
            stats_conv = lambda: conv.conv3d_kernel(x, wt, stats=True)
            t = [device_ms(f, reps) for f in (plain_conv, stats_conv,
                                              stats_conv, plain_conv)]
            rec["conv_ms"], rec["stats_conv_ms"] = min(t[0], t[3]), min(t[1], t[2])
            rec["epilogue_ms"] = rec["stats_conv_ms"] - rec["conv_ms"]
            rec["merge_ms"] = device_ms(lambda: triton_norm.merge(part, 1e-5), reps)
            rec["apply_ms"] = device_ms(lambda: triton_norm.apply(
                y3, o3, mean, rstd, gam, bet, "relu"), reps)
            rec["ms"] = rec["merge_ms"] + rec["apply_ms"] + rec["epilogue_ms"]
            rec["prev_ms"] = device_ms(
                lambda: norm.instance_norm_act_kernel(y, gam, bet), reps)
            rec["wall_ms"] = cuda_ms(with_part, reps)
            what = (f"; device: merge {rec['merge_ms']:.4f} + apply "
                    f"{rec['apply_ms']:.4f} + epilogue {rec['epilogue_ms']:.4f} "
                    f"(conv with it {rec['stats_conv_ms']:.4f}, without "
                    f"{rec['conv_ms']:.4f}) = {rec['ms']:.4f} ms against the "
                    f"three launches (prev) {rec['prev_ms']:.4f} ms")
        check(ok, f"IN+act from the conv's partials, conv {shape}: STATS y "
                  f"bitwise the plain instance's {same[0]}, partials bitwise "
                  f"repeatable {same[1]}; merged mean/rstd vs y's plain "
                  f"statistics {stats_err:.1e} (tol 1e-5); IN+act {err:.2f} bf16 "
                  f"ulp (tol 2), repeat bitwise {same[2]}" + what)
        out[shape] = rec
        del x, y, y0, part, part2, got, again, ref
    return out


def up_concats(calls):
    """(up input shape, skip channels) of each upsample of ``calls``: the
    skip's channels are the next conv's input less the up's."""
    return [(shape, calls[i + 1][1][4] - shape[4])
            for i, (name, shape) in enumerate(calls) if name == "upsample2x"]


def check_up_concat(calls, dev):
    """The decoder's up + skip concat at each upsample of ``calls``: up(x)
    written by resize2x.cu into the concat buffer, against the plain up (1
    bf16 ulp) and the skip (bitwise); device ms against the Triton up followed
    by ``torch.cat``. Returns {(up shape, skip channels): (ms, prev_ms)}."""
    import torch

    from brats2019_tpu_torch.ops import resize

    g = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for shape, cs in dict.fromkeys(up_concats(calls)):
        n, d, h, w, c = shape
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g,
                           device=dev).bfloat16()
        before = resize.upsample2x.launches_concat
        got = resize.upsample2x_concat_kernel(x, skip)
        torch.cuda.synchronize()
        err = bf16_ulps(got[..., :c], resize.upsample2x_plain(x))
        same = bool(torch.equal(got[..., c:], skip))
        into = resize.upsample2x.launches_concat - before
        ms = device_ms(lambda: resize.upsample2x_concat_kernel(x, skip), 10)
        prev = device_ms(lambda: torch.cat(
            [resize.upsample2x_kernel_triton(x), skip], -1), 10)
        check(err <= 1 and same and into == 1,
              f"up + skip concat {shape} + {cs}: up half {err:.2f} bf16 ulp "
              f"(tol 1), skip half bitwise {same}, {into} launch into the "
              f"buffer; device {ms:.4f} ms against Triton up + torch.cat "
              f"(prev) {prev:.4f} ms")
        out[(shape, cs)] = (ms, prev)
        del x, skip, got
    return out


# ------------------------------------------------------------------ phase 3 --

def read_labels(case_dirs):
    from brats2019_tpu_torch.utils.nifti import read_nifti

    out = []
    for d in case_dirs:
        name = os.path.basename(d)
        seg, _ = read_nifti(os.path.join(d, f"{name}_pred.nii.gz"),
                            apply_scaling=False)
        out.append(seg)
    return out


def small_reference(exp, work, dev) -> None:
    """Kernel path on the card vs the plain path on the CPU for both nets at
    a small input, same weights, bf16 compute on both."""
    import torch

    from brats2019_tpu_torch.utils.weights import build_unet

    g = torch.Generator().manual_seed(1)
    for stage, cfg in (("fine", exp.unet), ("coarse", exp.coarse_unet)):
        npz = os.path.join(work, stage, "params.npz")
        x = torch.randn((1, 32, 32, 32, 4), generator=g)
        with torch.inference_mode():
            ref = build_unet(cfg, npz, "cpu")(x)
            got = build_unet(cfg, npz, dev)(x.to(dev)).cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        check(bool(torch.isfinite(got).all()) and rel <= 5e-2 and agree >= 0.98,
              f"{stage} net (1,32,32,32,4) card vs CPU plain: logits "
              f"max|d|/max|ref| {rel:.3e} (tol 5e-2), argmax agreement "
              f"{agree:.5f} (tol 0.98)")


def time_slice(exp, work, case_dirs, dev, card):
    """Device ms/volume (CUDA events around the device program on an
    embedded canvas) and end-to-end s/volume (host clock around
    predict_dir: decode, prep, device, postprocess, NIfTI write)."""
    import torch

    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer.predictor import Predictor

    pred = Predictor(exp, os.path.join(work, "fine", "params.npz"),
                     os.path.join(work, "coarse", "params.npz"), device=dev)
    dev_ms, roi_ms, fin_ms = [], [], []
    for d in case_dirs:
        canvas, _, _ = pred.prepare(load_case(d).image)
        pred.predict_device(canvas)
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.inference_mode():
                ev[0].record()
                tiles, start = pred.program.stage_roi(canvas)
                ev[1].record()
                pred.program.stage_finish(tiles, start)
                ev[2].record()
            torch.cuda.synchronize()
            roi_ms.append(ev[0].elapsed_time(ev[1]))
            fin_ms.append(ev[1].elapsed_time(ev[2]))
            dev_ms.append(ev[0].elapsed_time(ev[2]))
    # F1: the crop handoff stays on the device
    with torch.inference_mode():
        tiles0, start0 = pred.program.stage_roi(canvas)
        torch.cuda.synchronize()
        err = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            tiles1, start1 = pred.program.stage_roi(canvas)
        except RuntimeError as e:
            err = e
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same = err is None and bool(torch.equal(start0, start1)
                                    and torch.equal(tiles0, tiles1))
    check(same, f"stage_roi under torch.cuda.set_sync_debug_mode('error'): "
                f"{'no device-to-host wait' if err is None else err}; start "
                f"{start0.tolist()} and tiles equal to a call outside it: {same}")
    e2e = []
    for d in case_dirs:
        t0 = time.perf_counter()
        pred.predict_dir(d, os.path.join(work, "timed_pred.nii.gz"))
        e2e.append(time.perf_counter() - t0)
    med = lambda v: sorted(v)[len(v) // 2]
    torch.cuda.reset_peak_memory_stats()
    pred.predict_device(canvas)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  device ms/vol median {med(dev_ms):.3f} (stage_roi "
          f"{med(roi_ms):.3f}, stage_finish {med(fin_ms):.3f}; all "
          f"{[round(v, 3) for v in dev_ms]}) on {card}", flush=True)
    print(f"  e2e s/vol median {med(e2e):.3f} (all "
          f"{[round(v, 3) for v in e2e]}) on {card}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    return med(e2e)


# ------------------------------------------------------------------ phase 6 --

# the predict programs besides the split cascade: (preset, CLI flags, the
# program make_predict_fn must choose, how many of the phase-3 cases)
OTHER_PROGRAMS = [("single_chip", [], "StagedSweep", CASES),
                  ("reference_parity", [], "Monolithic", 1),
                  ("cascade", ["--no-tta"], "Monolithic", 1)]


def program_calls(exp):
    """The kernel calls of one volume of ``exp``'s predict program: per
    origin of the sweep, the fine net at batch 8 with TTA (1 without), after
    the coarse net at batch 1 when cascading."""
    from brats2019_tpu_torch.infer.tiling import tile_origins

    inf = exp.infer
    canvas = tuple(inf.canvas)
    cascade = inf.cascade and exp.coarse_unet is not None
    roi = tuple(min(r, c) for r, c in zip(inf.roi_shape, canvas))
    origins = tile_origins(roi if cascade else canvas, inf.tile, inf.overlap)
    calls = unet_calls(exp.coarse_unet, 1, inf.coarse_shape) if cascade else []
    return calls + len(origins) * unet_calls(exp.unet, 8 if inf.tta_flips else 1,
                                             tuple(inf.tile))


def other_programs(work, case_dirs, dev, card):
    """Phase 6: the staged sweep (``single_chip`` at the flagship fine
    width, no cascade: 12 tiles of 128^3), the monolithic program
    (``reference_parity``: full-resolution TTA, its first level on
    ``conv3d.cu`` and the three-launch IN; the flagship ``cascade`` with
    ``--no-tta``) through ``cli.predict --device cuda`` with seeded random
    weights, the counters zeroed just before each run: labels in {0,1,2,4}
    at the input's shape, a repeat run bitwise equal, every launch counted
    and on its route; the staged sweep on the card against the CPU plain path
    at a small input; device ms/vol (CUDA events) and e2e s/vol."""
    import dataclasses

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.ops import conv
    from brats2019_tpu_torch.utils.nifti import read_nifti
    from brats2019_tpu_torch.utils.weights import init_params, save_params_npz

    out = {}
    for preset, flags, program, n_cases in OTHER_PROGRAMS:
        exp = get_preset(preset)
        if "--no-tta" in flags:
            exp = dataclasses.replace(
                exp, infer=dataclasses.replace(exp.infer, tta_flips=False))
        wd = work if preset == "cascade" else os.path.join(WORK, preset)
        if preset != "cascade":
            os.makedirs(os.path.join(wd, "fine"), exist_ok=True)
            save_params_npz(os.path.join(wd, "fine", "params.npz"),
                            init_params(exp.unet, SEED))
        label = f"{preset} {' '.join(flags)}".strip()
        dirs = case_dirs[:n_cases]
        outs = {}
        for run in ("first", "repeat"):
            paths = [os.path.join(WORK, f"{preset}_{run}_{os.path.basename(d)}.nii.gz")
                     for d in dirs]
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rcs = [predict_cli.main([d, "--preset", preset, "--workdir", wd,
                                     "--device", "cuda", "--output", p, *flags])
                   for d, p in zip(dirs, paths)]
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            routes = {"conv3d on the wgmma instance": ops.conv3d.launches_wgmma,
                      "conv3d with the statistics epilogue": ops.conv3d.launches_stats,
                      "instance_norm_act from partials":
                          ops.instance_norm_act.launches_partials,
                      "upsample2x into the concat buffer":
                          ops.upsample2x.launches_concat}
            check(rcs == [0] * len(dirs), f"{label}: predict CLI exit codes {rcs} "
                                          f"({wall:.1f} s for {len(dirs)} case(s))")
            outs[run] = [read_nifti(p, apply_scaling=False)[0] for p in paths]
        for d, a, b in zip(dirs, outs["first"], outs["repeat"]):
            vals = sorted(int(v) for v in set(a.ravel().tolist()))
            check(a.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4}
                  and bool((a == b).all()),
                  f"{label}, {os.path.basename(d)}: shape {a.shape}, labels "
                  f"{vals}, repeat run bitwise equal {bool((a == b).all())}")
        # every launch of the repeat run, and its route
        calls = program_calls(exp)
        want = {k: len(dirs) * sum(1 for n_, _ in calls if n_ == k) for k in FORWARD}
        convs = [sh for n_, sh in calls if n_ == "conv3d"]
        general = len(dirs) * sum(conv.plan_conv(*sh).instance == "mma_sync"
                                  for sh in convs)
        want_routes = {"conv3d on the wgmma instance": want["conv3d"] - general,
                       "conv3d with the statistics epilogue": want["conv3d"] - general,
                       "instance_norm_act from partials":
                           want["instance_norm_act"] - general,
                       "upsample2x into the concat buffer": want["upsample2x"]}
        got = {k: counts[k] for k in FORWARD}
        check(got == want and routes == want_routes and counts["conv3d"] > 0,
              f"{label}: launches {got} (expected {want}); routes {routes} "
              f"(expected {want_routes}; {general} convs on conv3d.cu, each "
              f"followed by the three-launch IN)")
        # the program's class, device ms/vol and e2e s/vol
        pc = (os.path.join(wd, "coarse", "params.npz")
              if exp.infer.cascade and exp.coarse_unet is not None else None)
        pred = Predictor(exp, os.path.join(wd, "fine", "params.npz"), pc, device=dev)
        check(type(pred.program).__name__ == program,
              f"{label}: make_predict_fn chose {type(pred.program).__name__} "
              f"(expected {program})")
        dev_ms, e2e = [], []
        for d in dirs:
            canvas, _, _ = pred.prepare(load_case(d).image)
            pred.predict_device(canvas)
            for _ in range(2):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                pred.predict_device(canvas)
                ev[1].record()
                torch.cuda.synchronize()
                dev_ms.append(ev[0].elapsed_time(ev[1]))
            t0 = time.perf_counter()
            pred.predict_dir(d, os.path.join(WORK, "timed_pred.nii.gz"))
            e2e.append(time.perf_counter() - t0)
        med = lambda v: sorted(v)[len(v) // 2]
        print(f"  {label} ({program}, {len(pred.program.origins)} tile(s)): "
              f"device ms/vol median {med(dev_ms):.3f} (all "
              f"{[round(v, 3) for v in dev_ms]}), e2e s/vol median "
              f"{med(e2e):.3f} on {card}", flush=True)
        out[label] = (med(dev_ms), med(e2e))
        if program == "StagedSweep":
            small_sweep_reference(exp, wd, dev)
        del pred
        torch.cuda.empty_cache()
    return out


def small_sweep_reference(exp, wd, dev) -> None:
    """The staged sweep on the card against the plain path on the CPU, same
    weights, bf16 compute on both, at a small input: a (24, 16, 16) canvas
    swept by two 16^3 tiles."""
    import dataclasses

    import torch

    from brats2019_tpu_torch.models.cascade import StagedSweep, make_predict_fn
    from brats2019_tpu_torch.utils.weights import build_unet

    cfg = dataclasses.replace(exp.infer, canvas=(24, 16, 16), tile=(16, 16, 16),
                              postproc="host")
    npz = os.path.join(wd, "fine", "params.npz")
    img = torch.randn((24, 16, 16, 4), generator=torch.Generator().manual_seed(4))
    res = {}
    for where in ("cpu", dev):
        prog = make_predict_fn(build_unet(exp.unet, npz, where), cfg, cfg.canvas)
        with torch.inference_mode():
            stacks, _ = prog.stage_sweep_stack(img.to(where))
            res[str(where)] = prog.sweep_probs_lr(stacks).cpu()
        ok_type = isinstance(prog, StagedSweep) and len(prog.origins) == 2
    ref, got = res["cpu"], res[str(dev)]
    err = (got - ref).abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(ok_type and bool(torch.isfinite(got).all()) and err <= 5e-2
          and agree >= 0.98,
          f"staged sweep (2 tiles of 16^3, fine net at full width) card vs CPU "
          f"plain: mean probabilities max|d| {err:.3e} (tol 5e-2), argmax "
          f"agreement {agree:.5f} (tol 0.98)")


# ------------------------------------------------- phase 2: the f32 routes --

# the f32 instances' tolerances against their plain versions (f32 math, TF32
# off), max|d|/max|ref|: f32 sums in another order
F32_TOL = {"conv3d": 1e-5, "instance_norm_act": 1e-5,
           "instance_norm_act_bwd": 1e-5}
F32_RESIZE_TOL = 1e-6
F32_SOURCE = {
    "conv3d": ("cuda", "brats2019_tpu_torch/csrc/conv3d.cu (conv3d_ndhwc_f32)"),
    # statistics from the f32 conv's epilogue, then the Triton merge and apply
    "instance_norm_act": ("triton", "brats2019_tpu_torch/ops/triton_norm.py"),
    # the grid, cluster and column forms by plan; the Triton kernels where
    # the plan keeps them (smoke's (1, 32^3, 16))
    "instance_norm_act_bwd": ("cuda", "brats2019_tpu_torch/csrc/in_act_bwd.cu "
                              "(in_act_bwd_ndhwc_f32, in_act_bwd_cluster_ndhwc_f32, "
                              "in_act_bwd_column_ndhwc_f32)"),
    "downsample2x": ("cuda", "brats2019_tpu_torch/csrc/resize2x.cu (downsample2x_ndhwc_f32)"),
    "upsample2x": ("cuda", "brats2019_tpu_torch/csrc/resize2x.cu (upsample2x_ndhwc_f32)"),
    "downsample2x_bwd": ("cuda", "brats2019_tpu_torch/csrc/resize2x.cu "
                         "(downsample2x_bwd_ndhwc_f32)"),
    # read in place from the concat gradient, in the instance plan_up_bwd picks
    "upsample2x_bwd": ("cuda", "brats2019_tpu_torch/csrc/resize2x.cu "
                       "(upsample2x_bwd_ndhwc_f32)"),
}


F32_EPILOGUE_SOURCE = "brats2019_tpu_torch/csrc/conv3d.cu (conv3d_stats_ndhwc_f32)"
# the tree's earlier route of an f32 row, timed beside it in the same run
F32_PREV_SOURCE = {
    "instance_norm_act": "brats2019_tpu_torch/ops/triton_norm.py (three launches)",
    "instance_norm_act_bwd": "brats2019_tpu_torch/ops/triton_norm.py (three launches)",
    "downsample2x": "brats2019_tpu_torch/ops/triton_resize.py",
    "upsample2x": "brats2019_tpu_torch/ops/triton_resize.py",
    "downsample2x_bwd": "brats2019_tpu_torch/ops/triton_resize.py",
    "upsample2x_bwd": "brats2019_tpu_torch/ops/triton_resize.py (after a copy of "
                      "the concat gradient's up half)",
}
# edge shapes of the two f32 resize backwards (forward input shapes; the up
# backward's concat gradient pitch, and whether g starts one f32 past a
# 16-byte boundary): an odd extent, a size-1 axis, C 12 (three pieces of
# the 4-piece instance), a misaligned g (copied for the kernel)
F32_BWD_EDGE_CALLS = [("upsample2x_bwd", (1, 5, 3, 9, 16), 24, False),
                      ("upsample2x_bwd", (1, 1, 7, 1, 32), 48, False),
                      ("upsample2x_bwd", (1, 4, 4, 4, 12), 20, False),
                      ("upsample2x_bwd", (1, 3, 4, 5, 16), 24, True),
                      ("downsample2x_bwd", (2, 9, 7, 13, 12), None, False),
                      ("downsample2x_bwd", (1, 2, 3, 2, 4), None, False),
                      ("downsample2x_bwd", (1, 6, 6, 6, 12), None, True)]


def accuracy_exp(tta=True):
    """The accuracy benchmark's configuration
    (``tests/test_accuracy_benchmark.py:43-56``): a 2-level, base-8 f32 net,
    no cascade, 32^3 tiles over a (64, 64, 48) canvas."""
    from brats2019_tpu_torch.configs import presets as P

    return P.ExperimentConfig(
        name="accuracy_benchmark",
        unet=P.UNetConfig(levels=2, base_features=8, compute_dtype="float32"),
        coarse_unet=None, train=P.TrainConfig(pool_shape=ACC_SHAPE),
        infer=P.InferenceConfig(
            canvas=ACC_SHAPE, tile=(32, 32, 32), cascade=False, tta_flips=tta,
            min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
            tta_precision="float32"))


def check_f32_kernels(calls, dev, up_pitch=None):
    """The f32 route of every kernel seam at each unique (kernel, shape) of
    ``calls``: within its tolerance of the plain version (f32 math, TF32
    off; the down backward bitwise), a repeat run bitwise equal, the route
    the counters show (every launch on ``launches_f32``; no wgmma conv; the
    up, the down, their backwards and the IN backward on their CUDA kernels
    where their plans say so), device time beside the plain version, the
    bound (f32 bytes, the f32 pipe) and the library call on the same f32
    inputs (the kernels with a CUDA route also beside their Triton form, the
    prev). An up backward reads the up half of a concat gradient of
    ``up_pitch[shape]`` channels (twice its C where absent) in place, and is
    also held bitwise to its result on a contiguous copy. Returns {(name,
    shape): the tuple of :func:`check_kernels`}."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.ops import conv, norm, resize

    g = torch.Generator(device=dev).manual_seed(11)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30)).item()
    up_pitch = up_pitch or {}
    sms = conv._sm_count(dev)
    results = {}
    for name, shape in dict.fromkeys(calls):
        gy = wt = gam = bet = None
        lib_x = None
        if name == "conv3d":
            n, d, h, w, ci, co = shape
            x = torch.randn((n, d, h, w, ci), generator=g, device=dev)
            wt = torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5
            kern = lambda: conv.conv3d_kernel(x, wt)
            plain = lambda: conv.conv3d_plain(x, wt)
        elif name in ("instance_norm_act", "instance_norm_act_bwd"):
            x = torch.randn(shape, generator=g, device=dev) * 3 + 1
            gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
            bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
            if name == "instance_norm_act":
                kern = lambda: norm.instance_norm_act_kernel(x, gam, bet)[0]
                plain = lambda: norm.instance_norm_act_plain(x, gam, bet)
            else:
                gy = torch.randn(shape, generator=g, device=dev)
                _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
                args = (x, gy, gam, bet, mean, rstd)
                kern = lambda: norm.instance_norm_act_bwd_kernel(*args)
                plain = lambda: norm.instance_norm_act_bwd_plain(*args)
        elif name == "downsample2x_bwd":
            gy = torch.randn((shape[0],) + tuple(v // 2 for v in shape[1:4])
                             + shape[4:], generator=g, device=dev)
            kern = lambda: resize.downsample2x_bwd_kernel(gy, shape)
            plain = lambda: resize.downsample2x_bwd_plain(gy, shape)
        elif name == "upsample2x_bwd":
            # the up half of a concat gradient, as the decoder's backward gives it
            pitch = up_pitch.get(shape, 2 * shape[4])
            cat = torch.randn((shape[0],) + tuple(2 * v for v in shape[1:4])
                              + (pitch,), generator=g, device=dev)
            gy = cat[..., :shape[4]]
            kern = lambda: resize.upsample2x_bwd_kernel(gy)
            plain = lambda: resize.upsample2x_bwd_plain(gy)
        else:
            x = torch.randn(shape, generator=g, device=dev)
            kfn, pfn = (getattr(resize, f"{name}_kernel"), getattr(resize, f"{name}_plain"))
            kern = lambda: kfn(x)
            plain = lambda: pfn(x)
        if name in ("downsample2x_bwd", "upsample2x_bwd"):
            lib_x = torch.randn(shape, generator=g, device=dev)
        wrapper = getattr(ops, name)
        side = ((conv.conv3d, "launches_wgmma"),) if name == "conv3d" else (
            ((wrapper, "launches_cuda"),) if hasattr(wrapper, "launches_cuda") else ())
        # the f32 resizes take resize2x.cu where C (and the up backward's
        # pitch) fill whole 16-byte pieces, the IN backward in_act_bwd.cu
        # where C fills whole vectors and the plan says so
        if name in ("upsample2x", "downsample2x"):
            on_cuda = resize.plan_resize(name, shape[4], torch.float32) == "resize2x.cu"
            prev_fn = getattr(resize, f"{name}_kernel_triton")
            prev_call = lambda: prev_fn(x)
        elif name == "upsample2x_bwd":
            on_cuda = resize.plan_resize(name, shape[4], torch.float32,
                                         resize.channel_pitch(gy)) == "resize2x.cu"
            # the tree's route before: a copy of the up half, then Triton
            prev_call = lambda: resize.upsample2x_bwd_kernel_triton(gy)
        elif name == "downsample2x_bwd":
            on_cuda = resize.plan_resize(name, shape[4], torch.float32) == "resize2x.cu"
            prev_call = lambda: resize.downsample2x_bwd_kernel_triton(gy, shape)
        elif name == "instance_norm_act_bwd":
            on_cuda = shape[4] % 4 == 0 and norm.plan_in_bwd(
                shape[0], math.prod(shape[1:4]), shape[4], conv._sm_count(dev),
                torch.float32).route == "in_act_bwd.cu"
            prev_call = lambda: norm.instance_norm_act_bwd_kernel_triton(*args)
        else:
            on_cuda = False
        before = [wrapper.launches, wrapper.launches_f32] + [getattr(f, a) for f, a in side]
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        took = [wrapper.launches - before[0], wrapper.launches_f32 - before[1]] + [
            getattr(f, a) - b for (f, a), b in zip(side, before[2:])]
        route_ok = took == [2, 2] + [2 * on_cuda] * len(side)
        extra = ""
        if name == "upsample2x_bwd":
            # in place at the concat's pitch, bitwise its result on a copy
            contig = resize.upsample2x_bwd_kernel(gy.contiguous())
            torch.cuda.synchronize()
            route_ok = route_ok and bool(torch.equal(got, contig))
            # the planner's shared memory is the kernel's
            plan = resize.plan_up_bwd(*shape, torch.float32, sms)
            have = resize._lib().upsample2x_bwd_smem_bytes(plan.pieces)
            route_ok = route_ok and have == plan.smem
            extra = (f", from a concat gradient of {cat.shape[-1]} "
                     f"channels in place, bitwise its contiguous copy's: "
                     f"{bool(torch.equal(got, contig))}, plan {plan.pieces} pieces "
                     f"tile {plan.tile} td {plan.td} ({plan.blocks} blocks, "
                     f"{plan.smem} B shared; kernel {have})")
            del contig
        if name == "downsample2x_bwd":
            extra = f", bitwise the plain version: {bool(torch.equal(got, ref))}"
            route_ok = route_ok and bool(torch.equal(got, ref))
        if name == "conv3d":
            # the planner's shared memory is the kernel's
            plan = conv.plan_conv(*shape, conv._sm_count(dev), torch.float32)
            have = conv._lib().conv3d_f32_smem_bytes(plan.box[0], plan.bn, plan.chunk)
            route_ok = route_ok and have == plan.smem_bytes
            extra = (f", plan box {plan.box} Co tile {plan.bn} slab {plan.chunk}, "
                     f"shared memory kernel {have} planner {plan.smem_bytes}")
        if name == "instance_norm_act_bwd":
            sums_err = max(rel(got[1], ref[1]), rel(got[2], ref[2]))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            extra = f", dgamma/dbeta {sums_err:.3e} (tol {F32_TOL[name]:g})"
            got, ref = got[0], ref[0]
        else:
            sums_err = 0.0
            same = bool(torch.equal(got, again))
        tol = F32_TOL.get(name, F32_RESIZE_TOL)
        err = rel(got, ref)
        abs_err = (got - ref).abs().max().item()
        ok = (err <= tol and sums_err <= tol and same and route_ok
              and got.dtype == torch.float32 and got.shape == ref.shape
              and bool(torch.isfinite(got).all()))
        reps = 10
        ms, plain_ms = device_ms(kern, reps), device_ms(plain, reps)
        wall, plain_wall = cuda_ms(kern, reps), cuda_ms(plain, reps)
        bytes_ms, ops_ms = bound_terms(name, shape, itemsize=4)
        lib = library_ms(name, lib_x if lib_x is not None else x, reps, gy=gy,
                         wt=wt, gam=gam, bet=bet)
        # the Triton form in the same run; where the plan keeps it, it is the
        # kernel itself
        prev = (device_ms(prev_call, reps) if on_cuda else
                ms if name in ("downsample2x", "instance_norm_act_bwd", "downsample2x_bwd",
                               "upsample2x_bwd") else None)
        check(ok, f"{name} f32 {shape}: max|d|/max|ref| {err:.3e} (tol {tol:g})"
                  f"{extra}, max|d| {abs_err:.3e}, repeat run bitwise equal: "
                  f"{same}, launches (all, f32, side route) {took}; device "
                  f"kernel {ms:.4f} ms"
                  + (f" (its Triton form, prev, {prev:.4f} ms)" if on_cuda else "")
                  + f", plain {plain_ms:.4f} ms, library call "
                  f"{lib:.4f} ms; bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
                  f"{bytes_ms:.4f}, operations {ops_ms:.4f})")
        results[(name, shape)] = (err, abs_err, ms, plain_ms, wall, plain_wall,
                                  bytes_ms, ops_ms, lib, prev)
        del got, again, ref, kern, plain
    return results


def check_f32_norm_partials(shapes, dev, timed=()):
    """Row 2f's route at every f32 conv shape in ``shapes`` (an IN follows
    each): the f32 STATS conv's y bitwise equal to the plain instance's, its
    partials bitwise repeatable, the merged mean and rstd within 1e-5 of y's
    plain statistics, IN+act from the partials within F32_TOL of the plain
    version and bitwise repeatable; for the shapes in ``timed`` also the
    row's three terms (the epilogue: STATS conv less conv, in turns; the
    merge; the apply) beside the three-launch form on the same y (prev).
    Returns {conv shape: dict}."""
    import torch

    from brats2019_tpu_torch.ops import conv, norm, triton_norm

    g = torch.Generator(device=dev).manual_seed(17)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    tol = F32_TOL["instance_norm_act"]
    out = {}
    for shape in dict.fromkeys(shapes):
        n, d, h, w, ci, co = shape
        x = torch.randn((n, d, h, w, ci), generator=g, device=dev)
        wt = torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5
        gam = torch.rand(co, generator=g, device=dev) + 0.5
        bet = torch.randn(co, generator=g, device=dev) * 0.2
        before = (conv.conv3d.launches_stats, conv.conv3d.launches_f32)
        y0 = conv.conv3d_kernel(x, wt)
        y, part = conv.conv3d_kernel(x, wt, stats=True)
        _, part2 = conv.conv3d_kernel(x, wt, stats=True)
        took = (conv.conv3d.launches_stats - before[0],
                conv.conv3d.launches_f32 - before[1])
        _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
        with_part = lambda: norm.instance_norm_act_kernel(y, gam, bet,
                                                          partials=part)
        (got, mean, rstd), again = with_part(), with_part()[0]
        ref = norm.instance_norm_act_plain(y, gam, bet)
        torch.cuda.synchronize()
        same = (bool(torch.equal(y, y0)), bool(torch.equal(part, part2)),
                bool(torch.equal(got, again)))
        stats_err = max(rel(mean, rmean), rel(rstd, rrstd))
        err = rel(got, ref)
        rec = {"err": err, "abs_err": (got - ref).abs().max().item()}
        ok = all(same) and stats_err <= 1e-5 and err <= tol and took == (2, 3)
        what = ""
        if shape in timed:
            n_, d_, h_, w_, c_ = y.shape
            y3 = y.view(n_, d_ * h_ * w_, c_)
            o3 = torch.empty_like(y3)
            reps = 10
            plain_conv = lambda: conv.conv3d_kernel(x, wt)
            stats_conv = lambda: conv.conv3d_kernel(x, wt, stats=True)
            t = [device_ms(f, reps) for f in (plain_conv, stats_conv,
                                              stats_conv, plain_conv)]
            rec["conv_ms"], rec["stats_conv_ms"] = min(t[0], t[3]), min(t[1], t[2])
            rec["epilogue_ms"] = rec["stats_conv_ms"] - rec["conv_ms"]
            # the route's one launch (merge folded into the apply) in turns
            # with the merge and the apply as two launches
            fused = lambda: triton_norm.merge_apply(y3, o3, part, gam, bet,
                                                    1e-5, "relu")
            two = lambda: triton_norm.apply(y3, o3, *triton_norm.merge(part, 1e-5),
                                            gam, bet, "relu")
            t = [device_ms(f, reps) for f in (two, fused, fused, two)]
            rec["two_launch_ms"], rec["merge_apply_ms"] = min(t[0], t[3]), min(t[1], t[2])
            rec["ms"] = rec["merge_apply_ms"] + rec["epilogue_ms"]
            rec["prev_ms"] = device_ms(
                lambda: norm.instance_norm_act_kernel(y, gam, bet), reps)
            rec["wall_ms"] = cuda_ms(with_part, reps)
            what = (f"; device: merge-apply {rec['merge_apply_ms']:.4f} (merge, "
                    f"then apply: {rec['two_launch_ms']:.4f}) + epilogue "
                    f"{rec['epilogue_ms']:.4f} (conv with it "
                    f"{rec['stats_conv_ms']:.4f}, without {rec['conv_ms']:.4f}) = "
                    f"{rec['ms']:.4f} ms against the three launches (prev) "
                    f"{rec['prev_ms']:.4f} ms")
        check(ok, f"f32 IN+act from the f32 conv's partials, conv {shape}: STATS "
                  f"y bitwise the plain instance's {same[0]}, partials bitwise "
                  f"repeatable {same[1]}, launches (STATS, f32) {took}; merged "
                  f"mean/rstd vs y's plain statistics {stats_err:.1e} (tol 1e-5); "
                  f"IN+act max|d|/max|ref| {err:.3e} (tol {tol:g}), repeat "
                  f"bitwise {same[2]}" + what)
        out[shape] = rec
        del x, y, y0, part, part2, got, again, ref
    return out


def check_f32_up_concat(calls, dev):
    """Row 6f's route at each upsample of ``calls``: the f32 up written by
    resize2x.cu (``upsample2x_ndhwc_f32``) into the concat buffer in one
    launch, within F32_RESIZE_TOL of the plain up (and whether bitwise), the
    skip half bitwise; device ms against what the tree did before, the
    Triton up made apart and copied into the buffer (prev). Returns {(up
    shape, skip channels): (ms, prev_ms)}."""
    import torch

    from brats2019_tpu_torch.ops import resize

    g = torch.Generator(device=dev).manual_seed(18)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    out = {}
    for shape, cs in dict.fromkeys(up_concats(calls)):
        n, d, h, w, c = shape
        x = torch.randn(shape, generator=g, device=dev)
        skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g, device=dev)

        def prev():
            buf = torch.empty((n, 2 * d, 2 * h, 2 * w, c + cs), device=dev)
            buf[..., :c] = resize.upsample2x_kernel_triton(x)
            buf[..., c:] = skip
            return buf

        before = (resize.upsample2x.launches_concat, resize.upsample2x.launches_f32)
        got = resize.upsample2x_concat_kernel(x, skip)
        into = (resize.upsample2x.launches_concat - before[0],
                resize.upsample2x.launches_f32 - before[1])
        ref = resize.upsample2x_plain(x)
        torch.cuda.synchronize()
        err = rel(got[..., :c], ref)
        bitwise = bool(torch.equal(got[..., :c], ref))
        same = bool(torch.equal(got[..., c:], skip))
        ms = device_ms(lambda: resize.upsample2x_concat_kernel(x, skip), 10)
        prev_ms = device_ms(prev, 10)
        check(err <= F32_RESIZE_TOL and same and into == (1, 1),
              f"f32 up + skip concat {shape} + {cs}: up half max|d|/max|ref| "
              f"{err:.3e} (tol {F32_RESIZE_TOL:g}; bitwise the plain up: "
              f"{bitwise}), skip half bitwise {same}, launches (into the "
              f"buffer, f32) {into}; device {ms:.4f} ms against the Triton up "
              f"+ copy into the buffer (prev) {prev_ms:.4f} ms")
        out[(shape, cs)] = (ms, prev_ms)
        del x, skip, got, ref
    return out


def check_f32_bwd_edges(dev):
    """The two f32 resize backwards on resize2x.cu at F32_BWD_EDGE_CALLS:
    the up backward within F32_RESIZE_TOL of the plain version, read in
    place at its pitch (a misaligned g copied first) and bitwise its result
    on a contiguous copy; the down backward bitwise the plain version; both
    bitwise repeatable, every launch on resize2x.cu and f32."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.ops import resize

    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    gen = torch.Generator(device=dev).manual_seed(19)
    for name, shape, pitch, shifted in F32_BWD_EDGE_CALLS:
        n, d, h, w, c = shape
        if name == "upsample2x_bwd":
            # misaligned: channels 1 .. C of the concat gradient (pitch % 4 == 0)
            buf = torch.randn((n, 2 * d, 2 * h, 2 * w, pitch), generator=gen, device=dev)
            gy = buf[..., int(shifted):int(shifted) + c]
            kern = lambda: resize.upsample2x_bwd_kernel(gy)
            plain = lambda: resize.upsample2x_bwd_plain(gy)
        else:
            gs = (n, d // 2, h // 2, w // 2, c)
            buf = torch.randn(math.prod(gs) + shifted, generator=gen, device=dev)
            gy = buf[int(shifted):].view(gs)
            kern = lambda: resize.downsample2x_bwd_kernel(gy, shape)
            plain = lambda: resize.downsample2x_bwd_plain(gy, shape)
        wrapper = getattr(ops, name)
        before = (wrapper.launches_cuda, wrapper.launches_f32)
        got, again = kern(), kern()
        took = (wrapper.launches_cuda - before[0], wrapper.launches_f32 - before[1])
        contig = (resize.upsample2x_bwd_kernel(gy.contiguous()) if name == "upsample2x_bwd"
                  else resize.downsample2x_bwd_kernel(gy.contiguous(), shape))
        ref = plain()
        torch.cuda.synchronize()
        err = rel(got, ref)
        same = bool(torch.equal(got, again) and torch.equal(got, contig))
        exact = bool(torch.equal(got, ref))
        ok = (same and took == (2, 2) and got.shape == ref.shape
              and (exact if name == "downsample2x_bwd" else err <= F32_RESIZE_TOL))
        check(ok, f"{name} f32 edge {shape}"
                  + (f" from pitch {pitch}" if pitch else "")
                  + (", g misaligned" if shifted else "")
                  + f": max|d|/max|ref| {err:.3e} (tol "
                  + ("bitwise" if name == "downsample2x_bwd" else f"{F32_RESIZE_TOL:g}")
                  + f"; bitwise the plain version: {exact}), repeat run and "
                  f"contiguous copy bitwise equal: {same}, launches (resize2x.cu, "
                  f"f32) {took}")
        del buf, gy, got, again, contig, ref


def launch_floor(dev, card):
    """The launch floor: 100 launches of each f32 resize at a tiny shape
    replayed from one CUDA graph: the 2x down of (1, 2, 2, 2, 4) (the
    Triton kernel and resize2x.cu), the 2x up of it (resize2x.cu), and the
    backwards with (1, 2, 2, 2, 4) on their fine side (the Triton kernels
    and resize2x.cu). Returns {what: us a launch}."""
    import torch

    from brats2019_tpu_torch.ops import resize

    x = torch.randn((1, 2, 2, 2, 4), device=dev)
    small = torch.randn((1, 1, 1, 1, 4), device=dev)
    shape = tuple(x.shape)
    calls = {
        "down (Triton)": lambda: resize.downsample2x_kernel_triton(x),
        "up (resize2x.cu)": lambda: resize.upsample2x_kernel(x),
        "down (resize2x.cu)": lambda: resize.downsample2x_kernel(x),
        "up backward (Triton)": lambda: resize.upsample2x_bwd_kernel_triton(x),
        "up backward (resize2x.cu)": lambda: resize.upsample2x_bwd_kernel(x),
        "down backward (Triton)": lambda: resize.downsample2x_bwd_kernel_triton(small, shape),
        "down backward (resize2x.cu)": lambda: resize.downsample2x_bwd_kernel(small, shape),
    }
    out = {k: device_ms(fn, 100) * 1e3 for k, fn in calls.items()}
    print("  launch floor, 100 launches of each f32 resize at (1, 2, 2, 2, 4) "
          "(the fine side) in one CUDA graph, us a launch: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items()) + f" on {card}",
          flush=True)
    return out


def in_bwd_probe_lib(k):
    """``csrc/in_act_bwd.cu`` built with ``-DIN_ACT_BWD_PROBE=k``: the kernel
    stops after step k (0 the launch and one grid barrier alone, 1 phase 1's
    loads and folds, 2 the block reduction, 3 the first barrier, 4 the
    merge)."""
    from brats2019_tpu_torch.ops import _build, norm

    return _build.load_library(f"in_act_bwd_probe{k}", ["in_act_bwd.cu"],
                               norm._SIG, extra_flags=(f"-DIN_ACT_BWD_PROBE={k}",))


def in_bwd_probe(k, x, g, gam, bet, mean, rstd, plan=None, bar=None):
    """Probe build k of the grid or the cluster form on ``plan`` (default
    the real plan of x's dtype; dx is not written), the grid form on the
    barrier pair ``bar`` (default a fresh zeroed pair)."""
    import torch

    from brats2019_tpu_torch.ops import _build, norm

    n, d, h, w, c = x.shape
    if plan is None:
        plan = norm.plan_in_bwd(n, d * h * w, c, _build.sm_count(x.device), x.dtype)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    lib = in_bwd_probe_lib(k)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, g, dx, mean, rstd, gam, bet)]
    if plan.cluster:
        rc = lib.in_act_bwd_cluster_ndhwc_f32(
            *ptrs, out.data_ptr(), out.data_ptr(), d * h * w, c, 1, plan.bps,
            plan.width, plan.threads, plan.keep, plan.smem, stream)
    else:
        part = torch.empty(2 * n * (plan.bps + 1) * c, dtype=torch.float32,
                           device=x.device)
        if bar is None:
            bar = torch.zeros(2, dtype=torch.int32, device=x.device)
        fn = (lib.in_act_bwd_ndhwc_f32 if x.dtype == torch.float32
              else lib.in_act_bwd_ndhwc_bf16)
        rc = fn(*ptrs, part.data_ptr(), out.data_ptr(), out.data_ptr(),
                bar.data_ptr(), n, d * h * w, c, 1, plan.bps, plan.threads,
                plan.keep, plan.smem, stream)
    _build.check(rc, f"in_act_bwd probe {k}")


IN_BWD_TERMS = ("memset", "launch", "phase 1", "block reduction", "barrier 1",
                "merge", "dx")


def in_bwd_terms(plan, args, reps=20):
    """One call of ``csrc/in_act_bwd.cu`` on ``plan`` (grid or cluster form)
    by step, device ms: the call as the port makes it (the grid form's
    barrier counters zeroed by a memset node), the kernel on one reused
    counter pair (which a launch leaves at 0 arrivals; no memset), and the
    probe builds on that pair, read as differences: memset = call - kernel,
    barrier 1 = probe 3 - probe 2 (the grid barrier, or the cluster's),
    launch = probe 0 - barrier 1, phase 1 = probe 1 - launch, block
    reduction = probe 2 - probe 1, merge = probe 4 - probe 3 (with the
    second barrier), dx = kernel - probe 4. ``args``: (x, g, gamma, beta,
    mean, rstd) of NDHWC x."""
    import torch

    from brats2019_tpu_torch.ops import norm

    x, gy, gam, bet, mean, rstd = args
    n, c = x.shape[0], x.shape[-1]
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    x3, g3 = x.view(n, -1, c), gy.view(n, -1, c)
    call = device_ms(lambda: norm.launch_in_act_bwd(plan, x3, g3, mean, rstd,
                                                    gam, bet, "relu"), reps)
    kern = device_ms(lambda: norm.launch_in_act_bwd(
        plan, x3, g3, mean, rstd, gam, bet, "relu", bar), reps)
    p = [device_ms(lambda k=k: in_bwd_probe(k, *args, plan=plan, bar=bar), reps)
         for k in range(5)]
    barrier = p[3] - p[2]
    launch = p[0] - barrier
    terms = (call - kern, launch, p[1] - launch, p[2] - p[1], barrier,
             p[4] - p[3], kern - p[4])
    return dict(zip(("call", "kernel") + IN_BWD_TERMS, (call, kern) + terms))


def f32_bwd_breakdown(shapes, dev, card, what):
    """Row 3f by step (:func:`in_bwd_terms`), summed over ``shapes`` (the IN
    backwards of ``what``, one a call; the column form's calls, which have
    no barrier, are left out). Returns {term: ms} with the call's and the
    kernel's ms."""
    import torch

    from brats2019_tpu_torch.ops import _build, norm

    g = torch.Generator(device=dev).manual_seed(19)
    tot = dict.fromkeys(("call", "kernel") + IN_BWD_TERMS, 0.0)
    for shape in shapes:
        n, d, h, w, c = shape
        plan = norm.plan_in_bwd(n, d * h * w, c, _build.sm_count(dev), torch.float32)
        if plan.column or plan.route != "in_act_bwd.cu":
            continue
        x = torch.randn(shape, generator=g, device=dev) * 3 + 1
        gy = torch.randn(shape, generator=g, device=dev)
        gam = torch.rand(c, generator=g, device=dev) + 0.5
        bet = torch.randn(c, generator=g, device=dev) * 0.2
        _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
        for k, v in in_bwd_terms(plan, (x, gy, gam, bet, mean, rstd)).items():
            tot[k] += v
    print(f"  instance_norm_act_bwd f32 per {what}, by step (probe builds, "
          f"device ms): call {tot['call']:.4f} = "
          + " + ".join(f"{k} {tot[k]:.4f}" for k in IN_BWD_TERMS)
          + f" on {card}", flush=True)
    return tot


# F3b: the f32 instance of csrc/winograd3d.cu against the plain Winograd (f32
# math, TF32 off), max|d|/max|ref|
F32_WINO_TOL = 1e-5
F32_WINO_SOURCE = "brats2019_tpu_torch/csrc/winograd3d.cu (winograd3d_ndhwc_f32)"


def check_f32_winograd(calls, dev, f32_results):
    """The f32 Winograd instance at each unique conv shape of ``calls`` (the
    accuracy config's tile batch, the ``smoke`` train step; their first
    convs have Ci = 4, a Ci % 16 != 0 case): within F32_WINO_TOL of its plain
    version and of the direct conv's, a repeat run bitwise equal, every launch
    on ``launches_f32`` and none on the wgmma instance; device time beside its
    bound (8/27 of the direct conv's products on the f32 pipe, 67 TFLOP/s),
    the plain version, the FFMA direct conv on the same inputs (its phase-2
    time, ``f32_results``) and cuDNN's f32 conv. Returns {shape: the tuple of
    :func:`check_kernels`, the direct conv's ms last}."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.ops import conv, winograd

    g = torch.Generator(device=dev).manual_seed(13)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    out = {}
    for shape in dict.fromkeys(sh for n, sh in calls if n == "conv3d"):
        n, d, h, w, ci, co = shape
        x = torch.randn((n, d, h, w, ci), generator=g, device=dev)
        wt = torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5
        kern = lambda: winograd.conv3d_winograd_kernel(x, wt)
        plain = lambda: winograd.conv3d_winograd_plain(x, wt)
        wino = ops.conv3d_winograd
        before = (wino.launches, wino.launches_f32, wino.launches_wgmma)
        got, again, ref = kern(), kern(), plain()
        direct = conv.conv3d_plain(x, wt)
        torch.cuda.synchronize()
        took = (wino.launches - before[0], wino.launches_f32 - before[1],
                wino.launches_wgmma - before[2])
        err, err_direct = rel(got, ref), rel(got, direct)
        same = bool(torch.equal(got, again))
        abs_err = (got - ref).abs().max().item()
        plan = winograd.plan_winograd(*shape, dtype=torch.float32)
        have = winograd._lib().winograd3d_f32_smem_bytes(plan.raw_channels, plan.bn,
                                                         plan.chunk)
        ok = (err <= F32_WINO_TOL and err_direct <= F32_WINO_TOL and same
              and took == (2, 2, 0) and got.dtype == torch.float32
              and plan.instance == "ffma_f32" and have == plan.smem_bytes
              and bool(torch.isfinite(got).all()))
        reps = 10
        ms, plain_ms = device_ms(kern, reps), device_ms(plain, reps)
        wall, plain_wall = cuda_ms(kern, reps), cuda_ms(plain, reps)
        bytes_ms, ops_ms = bound_terms("conv3d_winograd", shape, itemsize=4)
        lib = library_ms("conv3d", x, reps, wt=wt)
        direct_ms = f32_results[("conv3d", shape)][2]
        check(ok, f"conv3d_winograd f32 {shape}: max|d|/max|ref| {err:.3e} against "
                  f"its plain version, {err_direct:.3e} against the direct conv "
                  f"(tol {F32_WINO_TOL:g}), max|d| {abs_err:.3e}, repeat run "
                  f"bitwise equal: {same}, launches (all, f32, wgmma) {took}; plan "
                  f"Co tile {plan.bn} chunk {plan.chunk}, shared memory kernel {have} "
                  f"planner {plan.smem_bytes}; "
                  f"device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, FFMA direct "
                  f"conv {direct_ms:.4f} ms, cuDNN f32 {lib:.4f} ms; bound "
                  f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
                  f"operations {ops_ms:.4f})")
        out[shape] = (err, abs_err, ms, plain_ms, wall, plain_wall, bytes_ms,
                      ops_ms, lib, direct_ms)
        del got, again, ref, direct, kern, plain
    return out


# ------------------------------------------------------------------ phase 7 --

def accuracy_bounds(arms):
    """The bounds of ``tests/test_accuracy_benchmark.py:108-183`` on the
    arms {arm: [(labels, seg), ...]} (restated here: this script imports
    nothing of the JAX package's tests). Returns [(ok, what)]."""
    from brats2019_tpu_torch.infer.postprocess import postprocess_labels
    from brats2019_tpu_torch.train.metrics import region_dice_np

    dice = lambda arm: [region_dice_np(lab, seg) for lab, seg in arms[arm]]
    mean = lambda rows, r: float(sum(x[r] for x in rows) / len(rows))
    tta, no, ens, ema = (dice(a) for a in ("tta", "no_tta", "ensemble2", "ema"))
    out = []
    fmt = lambda rows: "/".join(f"{mean(rows, r):.4f}" for r in ("WT", "TC", "ET"))
    out.append((mean(tta, "WT") >= 0.88 and mean(tta, "TC") >= 0.88
                and mean(tta, "ET") >= 0.80,
                f"fixture validity: TTA WT/TC/ET {fmt(tta)} (bounds 0.88/0.88/0.80)"))
    out.append((mean(tta, "WT") >= mean(no, "WT") - 0.005
                and mean(tta, "TC") >= mean(no, "TC") + 0.01
                and mean(tta, "ET") >= mean(no, "ET") + 0.01,
                f"TTA beats a single view: {fmt(tta)} against {fmt(no)} "
                f"(WT -0.005, TC +0.01, ET +0.01)"))
    out.append((mean(ens, "WT") >= mean(tta, "WT") - 0.01
                and mean(ens, "TC") >= mean(tta, "TC") + 0.005,
                f"the 2-member ensemble buys WT/TC: {fmt(ens)} against TTA "
                f"{fmt(tta)} (WT -0.01, TC +0.005)"))
    out.append((all(abs(mean(ema, r) - mean(tta, r)) <= 0.05 for r in ("WT", "TC", "ET")),
                f"EMA weights track the final weights: {fmt(ema)} against "
                f"{fmt(tta)} (band 0.05)"))
    labels, seg = arms["no_tta_empty_et"][0]
    spurious = int((labels == 3).sum())
    raw = region_dice_np(labels, seg)
    fixed = region_dice_np(postprocess_labels(labels.copy(), min_component_voxels=0,
                                              et_min_voxels=200), seg)
    out.append((0 < spurious < 200 and raw["ET"] == 0.0 and fixed["ET"] == 1.0
                and fixed["WT"] == raw["WT"] and fixed["TC"] == raw["TC"],
                f"empty-ET case: {spurious} spurious ET voxels (bound (0, 200)), "
                f"ET Dice {raw['ET']} -> {fixed['ET']} with et_min_voxels 200, "
                f"WT/TC kept"))
    rows = arms["no_tta"] + arms["no_tta_empty_et"]
    raw = [region_dice_np(lab, s) for lab, s in rows]
    filt = [region_dice_np(postprocess_labels(lab.copy(), min_component_voxels=16,
                                              et_min_voxels=0), s) for lab, s in rows]
    out.append((mean(filt, "WT") >= mean(raw, "WT") and mean(filt, "TC") >= mean(raw, "TC"),
                f"small-component filter (16 voxels) helps WT: WT/TC "
                f"{mean(filt, 'WT'):.4f}/{mean(filt, 'TC'):.4f} against "
                f"{mean(raw, 'WT'):.4f}/{mean(raw, 'TC'):.4f}"))
    return out


# the f32 presets on the card (F3): each trains a few steps on hard synthetic
# cases of this shape and predicts one of them
F32_PRESETS = (("unit", (40, 40, 32)), ("smoke", (96, 96, 80)))
# top-2 gap of the CPU plain path's mean probabilities below which the card's
# f32 labels may differ from the CPU's (f32 sums in another order)
CARD_TIE = 1e-4
# the routes that only bf16 takes: every launch of an f32 slice leaves them at 0
BF16_ROUTES = (("conv3d", "launches_wgmma"),)
# the fused f32 routes and the f32 CUDA kernels: the f32 conv's STATS
# epilogue and IN+act from its partials, the f32 up on resize2x.cu into its
# concat buffer, the f32 down on resize2x.cu, the f32 IN backward on
# in_act_bwd.cu, the f32 up and down backwards on resize2x.cu
F32_FUSED = (("conv3d", "launches_stats"), ("instance_norm_act", "launches_partials"),
             ("upsample2x", "launches_cuda"), ("upsample2x", "launches_concat"),
             ("downsample2x", "launches_cuda"), ("instance_norm_act_bwd", "launches_cuda"),
             ("upsample2x_bwd", "launches_cuda"), ("downsample2x_bwd", "launches_cuda"))


def f32_counts():
    """{kernel: (launches, launches_f32)} of the seams with an f32 route, the
    bf16-only route counters and the fused f32 route counters."""
    from brats2019_tpu_torch import ops

    counts = {k: (getattr(ops, k).launches, getattr(ops, k).launches_f32)
              for k in F32_SOURCE}
    routes = lambda pairs: {f"{k}.{a}": getattr(getattr(ops, k), a) for k, a in pairs}
    return counts, routes(BF16_ROUTES), routes(F32_FUSED)


def check_f32_route(counts, bf16, fused, kernels, what, direct=True, bwd_cuda=(1, 1)):
    """Every launch of ``kernels`` on its f32 route, none on a bf16-only one
    (the wgmma conv); every IN+act after a direct f32 conv from its STATS
    partials (none on the Winograd backend, which has no epilogue:
    ``direct`` False), every up into its concat buffer on resize2x.cu, every
    down, up backward and down backward on resize2x.cu (each f32
    configuration has C % 4 == 0 at every resize, and its concats a pitch %
    4 == 0), and the IN backwards on in_act_bwd.cu where the plan puts them:
    ``bwd_cuda`` (those of a step's IN backwards, all of them)
    (:func:`f32_bwd_cuda_share`)."""
    ins, ups = counts["instance_norm_act"][0], counts["upsample2x"][0]
    bwds = counts["instance_norm_act_bwd"][0]
    want = {"conv3d.launches_stats": ins if direct else 0,
            "instance_norm_act.launches_partials": ins if direct else 0,
            "upsample2x.launches_cuda": ups, "upsample2x.launches_concat": ups,
            "downsample2x.launches_cuda": counts["downsample2x"][0],
            "instance_norm_act_bwd.launches_cuda": bwds * bwd_cuda[0] // bwd_cuda[1],
            "upsample2x_bwd.launches_cuda": counts["upsample2x_bwd"][0],
            "downsample2x_bwd.launches_cuda": counts["downsample2x_bwd"][0]}
    check(all(counts[k][0] == counts[k][1] > 0 for k in kernels)
          and not any(bf16.values()) and fused == want,
          f"{what}: launches (all, f32) {({k: counts[k] for k in kernels})}; "
          f"bf16-only routes {bf16}; fused routes {fused} (expected {want})")


def f32_bwd_cuda_share(preset):
    """(IN backwards a ``preset`` train step plans on in_act_bwd.cu, all of
    its IN backwards)."""
    import torch

    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.ops import _build, norm

    exp = get_preset(preset)
    sms = _build.sm_count(torch.device("cuda", 0))
    bwd = [sh for n, sh in train_calls(exp.unet, 1, exp.train.patch)
           if n == "instance_norm_act_bwd"]
    cuda = sum(norm.plan_in_bwd(sh[0], math.prod(sh[1:4]), sh[4], sms,
                                torch.float32).route == "in_act_bwd.cu" for sh in bwd)
    return cuda, len(bwd)


def f32_presets_slice():
    """Phase 7 part 0 (F3, F3b): ``unit`` and ``smoke`` train 3 steps (with
    an eval) and predict on the card, every launch on an f32 route, then
    predict again with the Winograd backend. Returns the launch counts of
    the last training run (the f32 backward kernels' record) and the f32
    Winograd launches of the two Winograd predicts."""
    import numpy as np

    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.cli import train as train_cli
    from brats2019_tpu_torch.data.case import discover_cases
    from brats2019_tpu_torch.utils.nifti import read_nifti

    from brats2019_tpu_torch import ops

    train_counts = None
    wino_launches = 0
    for preset, shape in F32_PRESETS:
        data = os.path.join(WORK, f"{preset}_cases")
        wd = os.path.join(WORK, f"{preset}_workdir")
        args = ["--preset", preset, "--synthetic", "2", "--synthetic-shape",
                *map(str, shape), "--synthetic-hard", "--data", data,
                "--workdir", wd, "--device", "cuda", "--steps", "3",
                "--log-every", "1", "--eval-every", "3"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc, _ = run_cli(train_cli.main, args)
        train_counts = f32_counts()
        with open(os.path.join(wd, "fine", "fine_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = [r for r in recs if "loss" in r]
        evals = [r for r in recs if "val_dice_mean" in r]
        check(rc == 0 and [r["step"] for r in steps] == [1, 2, 3]
              and all(math.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in steps)
              and len(evals) == 1,
              f"{preset} (f32) trains on the card: exit code {rc}, losses "
              f"{[round(r['loss'], 4) for r in steps]}, {len(evals)} eval "
              f"({time.perf_counter() - t0:.1f} s)")
        check_f32_route(*train_counts, list(F32_SOURCE), f"{preset} training",
                        bwd_cuda=f32_bwd_cuda_share(preset))
        case = discover_cases(data)[0]
        out = os.path.join(WORK, f"{preset}_pred.nii.gz")
        ops.reset_launch_counts()
        rc = predict_cli.main([case, "--preset", preset, "--workdir", wd,
                               "--device", "cuda", "--output", out])
        counts = f32_counts()
        seg = read_nifti(out, apply_scaling=False)[0] if rc == 0 else None
        check(rc == 0 and seg.shape == shape and set(np.unique(seg)) <= {0, 1, 2, 4},
              f"{preset} (f32) predicts on the card: exit code {rc}, shape "
              f"{None if seg is None else seg.shape}")
        check_f32_route(*counts, FORWARD, f"{preset} predict")
        wino_launches += winograd_f32_predict(preset, wd, case, seg)
    return train_counts, wino_launches


def winograd_f32_predict(preset, wd, case, direct_seg):
    """F3b on the card: ``preset`` (f32) predicts ``case`` once more through
    the predict CLI with ``set_backend("winograd")``: every conv on the f32
    Winograd instance (none on the direct conv, none on the wgmma instance),
    the rest on f32 routes, and labels equal to the direct backend's but on
    ties (top-2 gap of the direct backend's mean probabilities < CARD_TIE).
    Returns the Winograd launches."""
    import dataclasses

    import numpy as np

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.cli.common import load_stage_params
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.utils.nifti import read_nifti

    out = os.path.join(WORK, f"{preset}_pred_winograd.nii.gz")
    ops.set_backend("winograd")
    try:
        ops.reset_launch_counts()       # just before the path is driven
        t0 = time.perf_counter()
        rc = predict_cli.main([case, "--preset", preset, "--workdir", wd,
                               "--device", "cuda", "--output", out])
        wino = ops.conv3d_winograd
        took = (wino.launches, wino.launches_f32, wino.launches_wgmma,
                ops.conv3d.launches)
        counts = f32_counts()           # just after
    finally:
        ops.set_backend("direct")
    check(rc == 0 and took[0] == took[1] > 0 and took[2:] == (0, 0),
          f"{preset} (f32) predicts with the Winograd backend: exit code {rc} "
          f"({time.perf_counter() - t0:.1f} s); Winograd launches (all, f32, "
          f"wgmma) {took[:3]}, direct conv launches {took[3]}")
    check_f32_route(*counts, FORWARD[1:], f"{preset} predict (Winograd backend)",
                    direct=False)
    seg = read_nifti(out, apply_scaling=False)[0] if rc == 0 else None
    mism = (seg != direct_seg) if seg is not None else None
    diff = ties = 0
    if mism is not None and mism.any():
        exp = get_preset(preset)
        c = load_case(case)
        probs, _ = Predictor(exp, load_stage_params(
            dataclasses.replace(exp, workdir=wd), "fine"),
            device="cuda").predict_probs_arrays(c.image)
        top2 = np.sort(probs, axis=-1)[..., -2:]
        diff = int(mism.sum())
        ties = int((mism & ((top2[..., 1] - top2[..., 0]) < CARD_TIE)).sum())
    check(seg is not None and seg.shape == direct_seg.shape and diff == ties,
          f"{preset}: Winograd-backend labels equal the direct backend's but on "
          f"ties: {diff} voxel(s) differ, {ties} of them ties (top-2 gap < "
          f"{CARD_TIE:g})")
    return took[0]


def accuracy_on_card(dev, card):
    """Phase 7 part 1: the five arms of the accuracy benchmark at f32 on the
    card (the committed fixtures through the weight bridge, the hard cases of
    seeds 10, 11 and 13 from the port's generator): every bound, the route
    (f32 only), and labels against the CPU plain path except on ties.
    Returns the launch counts of the card's arms."""
    import numpy as np

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.data.synthetic import make_hard_case_arrays
    from brats2019_tpu_torch.infer.ensemble import EnsemblePredictor
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.utils.weights import load_params_npz

    fix = os.path.join(ROOT, "tests", "fixtures", "accuracy")
    m0, m1, ema = (load_params_npz(os.path.join(fix, f"{n}.npz"))
                   for n in ("hard_member0", "hard_member1", "hard_member0_ema"))
    hard = [make_hard_case_arrays(seed=s, shape=ACC_SHAPE) for s in (10, 11)]
    empty = [make_hard_case_arrays(seed=13, shape=ACC_SHAPE)]

    def arms_on(device):
        no = Predictor(accuracy_exp(tta=False), m0, device=device)
        preds = {"no_tta": no, "no_tta_empty_et": no,
                 "tta": Predictor(accuracy_exp(), m0, device=device),
                 "ensemble2": EnsemblePredictor(accuracy_exp(), [(m0, None), (m1, None)],
                                                device=device),
                 "ema": Predictor(accuracy_exp(), ema, device=device)}
        arms = {arm: [(p.predict_arrays(img)[0], seg) for img, seg in
                      (empty if arm == "no_tta_empty_et" else hard)]
                for arm, p in preds.items()}
        return arms, preds

    arms_on(dev)                        # first use: Triton's compiles
    ops.reset_launch_counts()           # just before the main path is driven
    t0 = time.perf_counter()
    on_card, _ = arms_on(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, bf16, fused = f32_counts()  # just after
    check_f32_route(counts, bf16, fused, FORWARD, "accuracy arms on the card")
    print(f"  accuracy arms (7 Predictor passes and 2 ensemble passes over the "
          f"hard cases, f32) on the card in {wall:.2f} s on {card}", flush=True)
    for ok, what in accuracy_bounds(on_card):
        check(ok, f"on the card: {what}")
    cpu, cpu_preds = arms_on("cpu")
    for arm in on_card:
        diff = ties = 0
        for (got, _), (want, _), (img, _) in zip(
                on_card[arm], cpu[arm], empty if arm == "no_tta_empty_et" else hard):
            mism = got != want
            if mism.any():
                probs = cpu_preds[arm].predict_probs_arrays(img)[0]
                top2 = np.sort(probs, axis=-1)[..., -2:]
                ties += int((mism & ((top2[..., 1] - top2[..., 0]) < CARD_TIE)).sum())
            diff += int(mism.sum())
        check(diff == ties, f"{arm}: labels on the card equal the CPU plain path's "
                            f"but on ties: {diff} voxel(s) differ, {ties} of them "
                            f"ties (top-2 gap < {CARD_TIE:g})")
    return counts


def read_case_outputs(case_dirs):
    """(labels, probs, uncertainty maps) written next to each case."""
    import numpy as np

    from brats2019_tpu_torch.utils.nifti import read_nifti

    out = []
    for d in case_dirs:
        name = os.path.basename(d)
        with np.load(os.path.join(d, f"{name}_probs.npz")) as z:
            probs, classes = z["probs"], z["classes"]
        unc = {r: read_nifti(os.path.join(d, f"{name}_unc_{r}.nii.gz"),
                             apply_scaling=False)[0]
               for r in ("whole", "core", "enhance")}
        out.append((read_labels([d])[0], probs, classes, unc))
    return out


def flagship_ensemble(exp, work, case_dirs, first, dev, card):
    """Phase 7 parts 2-5: the K = 2 flagship ensemble through the predict CLI
    with --save-probs and --save-uncertainty, ``evaluate``, the ensemble
    daemon's artifacts, and the ensemble's device ms/vol, e2e s/vol and peak
    memory."""
    import numpy as np

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import evaluate as evaluate_cli
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.data.preprocess import uncrop_from_canvas_np
    from brats2019_tpu_torch.infer.ensemble import EnsemblePredictor
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.utils.nifti import read_nifti
    from brats2019_tpu_torch.utils.weights import init_params, save_params_npz

    w2 = os.path.join(WORK, "member2")
    for stage, cfg, seed in (("fine", exp.unet, SEED + 2),
                             ("coarse", exp.coarse_unet, SEED + 3)):
        os.makedirs(os.path.join(w2, stage))
        save_params_npz(os.path.join(w2, stage, "params.npz"), init_params(cfg, seed))
    pair = lambda w: tuple(os.path.join(w, s, "params.npz") for s in ("fine", "coarse"))
    root = os.path.dirname(case_dirs[0])
    cli = [root, "--preset", "cascade", "--workdir", work, "--device", "cuda",
           "--save-probs", "--save-uncertainty"]
    convs = sum(1 for n, _ in unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
                + unet_calls(exp.unet, 8, exp.infer.roi_shape) if n == "conv3d")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = predict_cli.main(cli + ["--ensemble", w2])
    wall = time.perf_counter() - t0
    counts, on_wgmma = ops.launch_counts(), ops.conv3d.launches_wgmma
    want = convs * 2 * 2 * len(case_dirs)      # members x (label pass, probs pass)
    check(rc == 0 and counts["conv3d"] == on_wgmma == want,
          f"predict --ensemble (K = 2) --save-probs --save-uncertainty: exit code "
          f"{rc} ({wall:.1f} s for {len(case_dirs)} cases), {on_wgmma} wgmma convs "
          f"of {counts['conv3d']} (expected {want}: {convs} per member per volume "
          f"per pass, a label pass and a probability pass)")
    outs = read_case_outputs(case_dirs)
    ens = EnsemblePredictor(exp, [pair(work), pair(w2)], device=dev)
    for d, (labels, probs, classes, unc) in zip(case_dirs, outs):
        name = os.path.basename(d)
        vals = sorted(int(v) for v in np.unique(labels))
        psum = np.abs(probs.astype(np.float32).sum(-1) - 1.0).max()
        canvas, shape, bbox = ens._p.prepare(load_case(d).image)
        raw = uncrop_from_canvas_np(ens.labels_device(canvas).cpu().numpy(), shape,
                                    bbox, ens._p.canvas)
        agree = float((np.argmax(probs, -1) == raw).mean())
        check(labels.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4}
              and probs.shape == VOLUME_SHAPE + (4,) and probs.dtype == np.float16
              and list(classes) == [0, 1, 2, 4] and psum <= 4e-3 and agree >= 0.999
              and all(u.dtype == np.uint8 and u.shape == VOLUME_SHAPE and u.max() <= 100
                      for u in unc.values()),
              f"{name}: labels {vals} at {labels.shape}; probs {probs.dtype} "
              f"{probs.shape}, classes {list(classes)}, |sum - 1| <= {psum:.2e} "
              f"(f16 rounding, tol 4e-3); argmax of the saved probs agrees with "
              f"the ensemble's labels before postprocessing on {agree:.6f} of "
              f"voxels (tol 0.999); uncertainty maxima "
              f"{ {r: int(u.max()) for r, u in unc.items()} } (<= 100)")
    rc = predict_cli.main(cli + ["--ensemble", w2])
    again = read_case_outputs(case_dirs)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               and all(np.array_equal(a[3][r], b[3][r]) for r in a[3])
               for a, b in zip(outs, again))
    check(rc == 0 and same, f"repeat predict --ensemble: labels, probs and "
                            f"uncertainty bitwise equal {same}")

    # the primary twice: (a + a) / 2 is the Predictor's probability path
    rc = predict_cli.main(cli + ["--ensemble", work])
    twice = read_case_outputs(case_dirs)
    pred = Predictor(exp, *pair(work), device=dev)
    for d, (labels, probs, _, _), ref in zip(case_dirs, twice, first):
        path = pred.predict_probs_dir(d, os.path.join(WORK, "one_probs.npz"))
        with np.load(path) as z:
            same = np.array_equal(z["probs"], probs)
        agree = float((labels == ref).mean())
        check(rc == 0 and same and agree >= 0.999,
              f"{os.path.basename(d)}: --ensemble of the primary itself: probs "
              f"bitwise the Predictor's probability path {same}; labels agree "
              f"with phase 3's on {agree:.6f} of voxels (tol 0.999)")
    del pred

    # evaluate, the ensemble, on the labelled phase-3 cases
    out_json = os.path.join(WORK, "evaluate.json")
    rc = evaluate_cli.main([root, "--preset", "cascade", "--workdir", work,
                            "--ensemble", w2, "--hd95", "--sens-spec", "--device",
                            "cuda", "--out", out_json])
    with open(out_json) as f:
        rep = json.load(f)
    dice = [v for c in rep["per_case"].values() for k, v in c.items()
            if k in ("WT", "TC", "ET")]
    check(rc == 0 and rep["n_cases"] == len(case_dirs) and len(dice) == 3 * len(case_dirs)
          and all(0.0 <= v <= 1.0 for v in dice)
          and all(f"HD95_{r}" in rep["mean"] and f"Sens_{r}" in rep["mean"]
                  for r in ("WT", "TC", "ET")),
          f"evaluate --ensemble --hd95 --sens-spec: exit code {rc}, mean {rep['mean']}")

    ensemble_daemon(work, w2, case_dirs[0])

    # device ms/vol of the members' probability programs and the
    # accumulation, K = 1 and 2; e2e s/vol; peak memory
    med = lambda v: sorted(v)[len(v) // 2]
    ens1 = EnsemblePredictor(exp, [pair(work)], device=dev)
    canvases = [ens._p.prepare(load_case(d).image)[0] for d in case_dirs]
    for k, e in ((1, ens1), (2, ens)):
        e.accumulate(canvases[0])
        ms = []
        for canvas in canvases:
            for _ in range(2):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                e.accumulate(canvas)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
        print(f"  ensemble K = {k}: device ms/vol median {med(ms):.3f} (all "
              f"{[round(v, 3) for v in ms]}) on {card}", flush=True)
    e2e = []
    for d in case_dirs:
        t0 = time.perf_counter()
        ens.predict_dir(d, os.path.join(WORK, "ens_pred.nii.gz"))
        e2e.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ens.accumulate(canvases[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  ensemble K = 2: e2e s/vol median {med(e2e):.3f} (all "
          f"{[round(v, 3) for v in e2e]}), peak device memory {peak:.2f} GiB "
          f"on {card}", flush=True)
    del ens, ens1, canvases
    torch.cuda.empty_cache()


def ensemble_daemon(work, w2, case_dir):
    """Phase 7 part 4: one serve daemon with --ensemble, --save-probs and
    --save-uncertainty over HTTP; POST /predict one case and GET its probs
    and whole-tumour uncertainty artifacts."""
    import numpy as np

    import tempfile

    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.utils.nifti import read_nifti

    root = os.path.join(WORK, "serve_ensemble")
    watch, out = os.path.join(root, "watch"), os.path.join(root, "out")
    os.makedirs(watch)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    name = os.path.basename(case_dir)

    def client(daemon_done):
        deadline = time.time() + 600
        while time.time() < deadline and not daemon_done.is_set():
            try:
                if _get_json(base + "/healthz", timeout=5).get("warm"):
                    break
            except OSError:
                pass
            time.sleep(0.2)
        req = urllib.request.Request(
            base + "/predict?format=json&timeout=300",
            data=json.dumps({"case_dir": case_dir}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=330) as r:
            answer = json.loads(r.read())
        arts = {}
        for kind in ("probs", "unc_whole"):
            with urllib.request.urlopen(f"{base}/artifact?case={name}&kind={kind}",
                                        timeout=60) as r:
                arts[kind] = r.read()
        return answer, arts

    rc, (answer, arts) = run_daemon(
        [watch, "--preset", "cascade", "--workdir", work, "--device", "cuda",
         "--poll", "0.05", "--output-dir", out, "--ensemble", w2, "--save-probs",
         "--save-uncertainty", "--http", str(port), "--warmup"], client)
    with np.load(io.BytesIO(arts["probs"])) as z:
        probs_shape = z["probs"].shape
    with tempfile.NamedTemporaryFile(suffix=".nii.gz", dir=WORK) as f:
        f.write(arts["unc_whole"])
        f.flush()
        unc = read_nifti(f.name, apply_scaling=False)[0]
    check(rc == 0 and answer.get("error") is None and answer["case"] == name
          and probs_shape == VOLUME_SHAPE + (4,) and unc.shape == VOLUME_SHAPE
          and unc.max() <= 100,
          f"serve --ensemble --save-probs --save-uncertainty --http: exit code "
          f"{rc}, POST /predict answered {answer.get('case')}, GET "
          f"/artifact?kind=probs {len(arts['probs'])} bytes {probs_shape}, "
          f"kind=unc_whole {len(arts['unc_whole'])} bytes {unc.shape} max "
          f"{int(unc.max())}")


# ------------------------------------------------------------------ phase 4 --

class _Tee(io.TextIOBase):
    """Write to several text streams (the train CLI's output is both shown
    and searched)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(main_fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main_fn(args)
    return rc, buf.getvalue()


def check_train_log(workdir, stage):
    """Every logged step: finite loss, grad_norm > 0; evals logged."""
    with open(os.path.join(workdir, stage, f"{stage}_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "loss" in r]
    evals = [r for r in recs if "val_dice_mean" in r]
    ok = bool(train) and all(math.isfinite(r["loss"]) and r["grad_norm"] > 0
                             for r in train)
    check(ok and [r["step"] for r in train] == [5, 10, 15, 20] and len(evals) == 2,
          f"{stage} log: steps {[r['step'] for r in train]}, losses "
          f"{[round(r['loss'], 4) for r in train]}, grad_norm "
          f"{[round(r['grad_norm'], 4) for r in train]}, val_dice_mean "
          f"{[round(r['val_dice_mean'], 4) for r in evals]}")


def train_slice(cases_root, case_dirs, stage_calls):
    """The train CLI on the card at full cascade width, resume, serve."""
    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.cli import train as train_cli
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE

    tw = os.path.join(WORK, "train_workdir")
    args = ["--data", cases_root, "--preset", "cascade", "--stage", "all",
            "--device", "cuda", "--workdir", tw, "--log-every", "5",
            "--eval-every", "10", "--checkpoint-every", "10"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, _ = run_cli(train_cli.main, args + ["--steps", str(TRAIN_STEPS)])
    counts = ops.launch_counts()
    on_wgmma = ops.conv3d.launches_wgmma
    bwd_cuda = {"instance_norm_act_bwd": ops.instance_norm_act_bwd.launches_cuda,
                "upsample2x_bwd": ops.upsample2x_bwd.launches_cuda}
    check(rc == 0, f"train CLI exit code {rc} ({time.perf_counter() - t0:.1f} s "
                   f"for {TRAIN_STEPS} steps of each stage)")
    for stage in ("coarse", "fine"):
        check_train_log(tw, stage)
    per_step = {stage: {k: sum(1 for n, _ in calls if n == k) for k in KERNELS}
                for stage, calls in stage_calls.items()}
    print(f"  launches on the training slice: {counts}; per train step "
          f"{per_step}", flush=True)
    for k in BACKWARD:
        want = TRAIN_STEPS * sum(per_step[st][k] for st in per_step)
        check(counts[k] > 0 and counts[k] == want,
              f"{k} launched {counts[k]} times on the training slice "
              f"(expected {want})")
    check(all(v == counts[k] for k, v in bwd_cuda.items()),
          f"backward launches on the CUDA C++ kernels: {bwd_cuda} of "
          f"{ {k: counts[k] for k in bwd_cuda} } (in_act_bwd.cu, resize2x.cu)")
    for k in FORWARD:
        check(counts[k] > 0, f"{k} launched {counts[k]} times on the training slice")
    check(on_wgmma == counts["conv3d"],
          f"{on_wgmma} of the {counts['conv3d']} conv launches (forward, dgrad, "
          f"evals) of the training slice took the wgmma instance")
    rc, out = run_cli(train_cli.main, args + ["--steps", str(TRAIN_STEPS + 4)])
    for stage in ("coarse", "fine"):
        check(rc == 0 and f"[{stage}] resumed from step {TRAIN_STEPS}" in out,
              f"rerun with --steps {TRAIN_STEPS + 4}: {stage} resumed from "
              f"step {TRAIN_STEPS} (exit code {rc})")
    rc = predict_cli.main([cases_root, "--preset", "cascade", "--workdir", tw,
                           "--device", "cuda"])
    check(rc == 0, f"predict CLI on the trained workdir: exit code {rc}")
    for d, seg in zip(case_dirs, read_labels(case_dirs)):
        vals = sorted(int(v) for v in set(seg.ravel().tolist()))
        check(seg.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4},
              f"trained workdir, {os.path.basename(d)}: shape {seg.shape}, "
              f"labels {vals}")
    return counts


def step_reference(exp, dev):
    """One train step's loss and grads, kernel path on the card against the
    plain path on the CPU, bf16 compute on both, same weights and batch, at
    STEP_REF_PATCH (the coarse stage's patch; there the fine net's deepest
    IN normalises over 4^3 voxels, the coarse net's over 8^3). bf16 rounding
    alone moves these grads (the plain bf16 path against the same net in
    f32), and by more the farther a parameter sits from the head: 0.02-0.4%
    relative L2 for the head and the last IN, 20-28% at the stem, at random
    weights. So
    each path is measured against the f32 plain path, and the card path may
    be no noisier than the plain bf16 path: each parameter's card grad no
    farther from f32 than GRAD_FACTOR x the CPU bf16 grad's distance +
    GRAD_ABS (an added error above ~0.8x a parameter's own bf16 noise
    fails), all grads together no farther than GRAD_FACTOR_ALL x +
    GRAD_ABS. Loss: LOSS_TOL relative, card vs CPU bf16. The per-parameter
    distances are written under OUT."""
    import dataclasses

    import torch

    from brats2019_tpu_torch.train.loop import init_stage
    from brats2019_tpu_torch.train.step import make_microbatch_loss

    g = torch.Generator().manual_seed(2)
    cfg = dataclasses.replace(exp.train, patch=STEP_REF_PATCH)
    for stage, ucfg in (("fine", exp.unet), ("coarse", exp.coarse_unet)):
        t0 = time.perf_counter()
        imgs = torch.randn((1, *STEP_REF_PATCH, 4), generator=g)
        segs = torch.randint(0, 4, (1, *STEP_REF_PATCH), generator=g)
        loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
        runs = {}
        for key, where, dt in (("cpu_bf16", "cpu", "bfloat16"),
                               ("card_bf16", dev, "bfloat16"),
                               ("cpu_f32", "cpu", "float32")):
            model, _ = init_stage(dataclasses.replace(ucfg, compute_dtype=dt),
                                  cfg, where)
            loss, _ = loss_fn(model, imgs.to(where), segs.to(where))
            loss.backward()
            runs[key] = (loss.item(), {n: p.grad.float().cpu()
                                       for n, p in model.named_parameters()})
        f32 = runs["cpu_f32"][1]
        names = list(f32)
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        cat = lambda d: torch.cat([d[n].flatten() for n in names])
        err = {k: {n: rel(runs[k][1][n], f32[n]) for n in names}
               for k in ("cpu_bf16", "card_bf16")}
        tot = {k: rel(cat(runs[k][1]), cat(f32)) for k in err}
        vs_cpu = {n: rel(runs["card_bf16"][1][n], runs["cpu_bf16"][1][n])
                  for n in names}
        worst = max(names, key=lambda n: err["card_bf16"][n]
                    - 2 * err["cpu_bf16"][n])
        l_cpu, l_card = runs["cpu_bf16"][0], runs["card_bf16"][0]
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        finite = all(bool(torch.isfinite(v).all())
                     for v in runs["card_bf16"][1].values())
        ok = (finite and loss_rel <= LOSS_TOL
              and all(err["card_bf16"][n]
                      <= GRAD_FACTOR * err["cpu_bf16"][n] + GRAD_ABS
                      for n in names)
              and tot["card_bf16"] <= GRAD_FACTOR_ALL * tot["cpu_bf16"] + GRAD_ABS)
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"step_reference_{stage}.json"), "w") as f:
            json.dump({"loss": {k: v[0] for k, v in runs.items()}, "all": tot,
                       "per_param": {n: {"card_bf16": err["card_bf16"][n],
                                         "cpu_bf16": err["cpu_bf16"][n],
                                         "card_vs_cpu": vs_cpu[n]}
                                     for n in names}}, f, indent=1)
        med = lambda v: sorted(v)[len(v) // 2]
        ratio = max(err["card_bf16"][n] / err["cpu_bf16"][n] for n in names)
        check(ok, f"{stage} train step, patch {STEP_REF_PATCH}, card vs CPU plain, "
                  f"bf16, {time.perf_counter() - t0:.1f} s: "
                  f"loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}, tol "
                  f"{LOSS_TOL:g}; f32 {runs['cpu_f32'][0]:.6f}); largest "
                  f"card/CPU-bf16 distance ratio {ratio:.3f} (bound "
                  f"{GRAD_FACTOR:g}x + {GRAD_ABS:g}); grads vs f32, all "
                  f"params: card {tot['card_bf16']:.3e}, CPU bf16 "
                  f"{tot['cpu_bf16']:.3e}; per param median card "
                  f"{med(err['card_bf16'].values()):.3e}, CPU bf16 "
                  f"{med(err['cpu_bf16'].values()):.3e}; closest to the "
                  f"bound {worst} card {err['card_bf16'][worst]:.3e} vs CPU "
                  f"bf16 {err['cpu_bf16'][worst]:.3e}; card vs CPU bf16 "
                  f"median {med(vs_cpu.values()):.3e}")


def _kernel_us(evt) -> float:
    """Device time of a profiler row that is a device kernel (0 for the
    host-side ops, which would count their kernels a second time)."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_steps(step, pool, stage, first_step, n, step_ms):
    """torch.profiler over n train steps: device kernel time by name (top
    rows printed, the whole table under OUT), and its sum against
    the unprofiled step time (CUDA events) as the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(first_step, first_step + n):
                step(pool, i)
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages() if _kernel_us(e) > 0),
                      key=_kernel_us, reverse=True)
        busy_ms = sum(_kernel_us(e) for e in rows) / n / 1e3
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"train_profile_{stage}.txt"), "w") as f:
            for e in rows:
                f.write(f"{_kernel_us(e) / n:12.1f} us/step  "
                        f"{e.count // n:5d}/step  {e.key}\n")
        print(f"  {stage} profile: device kernels {busy_ms:.3f} ms per step = "
              f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms step "
              f"(idle {100 * (1 - busy_ms / step_ms):.1f}%)", flush=True)
        for e in rows[:15]:
            print(f"    {_kernel_us(e) / n / 1e3:9.3f} ms/step "
                  f"{e.count // n:4d}x  {e.key[:100]}", flush=True)
    except Exception as e:  # noqa: BLE001 — an extra measurement only
        print(f"  {stage} profile: not measured ({type(e).__name__}: {e})",
              flush=True)


def random_pool(cfg, dev):
    """A device pool of random cases at the stage's canvas (the timed train
    steps' input, made in bulk on the card)."""
    import types

    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    k = cfg.pool_cases_per_device
    canvas = tuple(cfg.pool_shape)
    rng = np.random.default_rng(3)
    return types.SimpleNamespace(
        image=torch.randn((k,) + canvas + (4,), generator=g, device=dev).bfloat16(),
        seg=torch.randint(0, 4, (k,) + canvas, generator=g, device=dev,
                          dtype=torch.uint8),
        fg_host=np.stack([np.stack([rng.integers(0, c, 4096) for c in canvas],
                                   -1).astype(np.int32) for _ in range(k)]))


def timed_steps(step, pool, warm=3, reps=10):
    """Mean ms of ``reps`` train steps after ``warm`` (CUDA events), and the
    last step's aux."""
    import torch

    for i in range(warm):
        step(pool, i)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for i in range(warm, warm + reps):
        aux = step(pool, i)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps, aux


def time_training(exp, dev, card, results, stage_calls):
    """Per stage: train step ms (CUDA events, 10 steps after 3 warm-up
    steps) on a device pool of random cases at the stage's canvas, patches/s,
    MFU, peak device memory, each kernel's ms per step against its plain
    version (phase-2 times at the step's shapes), then a profile."""
    import torch

    from brats2019_tpu_torch.train.loop import init_stage, stage_config
    from brats2019_tpu_torch.train.step import TrainStep, make_microbatch_loss
    from brats2019_tpu_torch.utils.flops import mfu, train_step_flops

    name = torch.cuda.get_device_name(0)
    out = {}
    for stage in ("coarse", "fine"):
        ucfg, cfg, _ = stage_config(exp, stage)
        model, opt = init_stage(ucfg, cfg, dev)
        pool = random_pool(cfg, dev)
        step = TrainStep(model, cfg, make_microbatch_loss(
            cfg, ucfg.stem_downsample, lowres=True), opt)
        for i in range(3):
            step(pool, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        reps = 10
        ev[0].record()
        for i in range(3, 3 + reps):
            aux = step(pool, i)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / reps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flops = train_step_flops(ucfg, cfg)
        m = mfu(flops, ms / 1e3, name)
        check(math.isfinite(float(aux["loss"])),
              f"{stage} timed steps: loss {float(aux['loss']):.4f}")
        print(f"  {stage} train step {ms:.3f} ms (CUDA events, mean of {reps} "
              f"after 3 warm-up), {cfg.batch_per_device * 1e3 / ms:.2f} "
              f"patches/s, MFU {'n/a' if m is None else f'{100 * m:.2f}%'} "
              f"({flops / 1e12:.3f} TFLOP/step), peak device memory "
              f"{peak:.2f} GiB, patch {cfg.patch} on {card}", flush=True)
        kern = {}
        for kname in BACKWARD + FORWARD:
            mine = [results[(n, sh)] for n, sh in stage_calls[stage] if n == kname]
            kern[kname] = tuple(sum(r[i] for r in mine) for i in (2, 3, 4, 5))
            prev = (f" (mma.sync kernel, prev: {sum(r[9] for r in mine):.4f})"
                    if kname == "conv3d" else "")
            print(f"    {kname}: {len(mine)} calls/step, device "
                  f"{kern[kname][0]:.4f} ms/step in kernels{prev} vs "
                  f"{kern[kname][1]:.4f} ms/step plain torch; wall "
                  f"{kern[kname][2]:.4f} vs {kern[kname][3]:.4f}", flush=True)
        out[stage] = kern
        profile_steps(step, pool, stage, 3 + reps, 3, ms)
        del model, opt, step, pool
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 5 --

def _get_json(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_daemon(argv, client=None):
    """``cli.serve.main(argv)`` on this (the main) thread, where it installs
    its signal handlers and launches every kernel; ``client(daemon_done)``
    runs on a second thread, gives up when the event is set (the daemon ended
    by itself) and otherwise ends by sending this process SIGTERM. Returns
    the daemon's exit code and what the client returned; re-raises what it
    raised."""
    from brats2019_tpu_torch.cli import serve as serve_cli

    old = {sig: signal.getsignal(sig)
           for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)}
    box = {}
    daemon_done = threading.Event()

    def run_client():
        try:
            box["value"] = client(daemon_done)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            if not daemon_done.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    thread = None
    if client is not None:
        thread = threading.Thread(target=run_client, daemon=True)
        thread.start()
    try:
        rc = serve_cli.main(argv)
    finally:
        daemon_done.set()
        if thread is not None:
            thread.join(60)
        for sig, handler in old.items():
            signal.signal(sig, handler)
    if "error" in box:
        raise box["error"]
    return rc, box.get("value")


def served_labels(out_dir, case_dirs):
    from brats2019_tpu_torch.utils.nifti import read_nifti

    return [read_nifti(os.path.join(out_dir, os.path.basename(d) + "_pred.nii.gz"),
                       apply_scaling=False)[0] for d in case_dirs]


def serve_log(out_dir):
    with open(os.path.join(out_dir, "serve_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def time_backends(exp, work, case_dirs, dev, card):
    """Device ms/vol of the predict program with each conv backend (CUDA
    events, host postprocessing so only the program is read), then the
    connected components + tiny-ET step on the ROI labels: on the device
    (host clock around a synchronised call: it syncs to test convergence)
    and in host scipy on the same labels."""
    import dataclasses

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer.postprocess import postprocess_labels
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.ops.connected_components import postprocess_device

    host_exp = dataclasses.replace(
        exp, infer=dataclasses.replace(exp.infer, postproc="host"))
    pred = Predictor(host_exp, os.path.join(work, "fine", "params.npz"),
                     os.path.join(work, "coarse", "params.npz"), device=dev)
    canvases = [pred.prepare(load_case(d).image)[0] for d in case_dirs]
    med = lambda v: sorted(v)[len(v) // 2]
    out = {}
    for backend in ("direct", "winograd", "winograd", "direct"):
        ops.set_backend(backend)
        try:
            pred.predict_device(canvases[0])
            for canvas in canvases:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                pred.predict_device(canvas)
                ev[1].record()
                torch.cuda.synchronize()
                out.setdefault(backend, []).append(ev[0].elapsed_time(ev[1]))
        finally:
            ops.set_backend("direct")
    for backend, v in out.items():
        print(f"  device ms/vol, {backend} conv backend: median {med(v):.3f} "
              f"(all {[round(t, 3) for t in v]}) on {card}", flush=True)
    cfg = exp.infer
    dev_ms, host_ms = [], []
    for canvas in canvases:
        labels_r, _ = pred.predict_device(canvas)
        labels_np = labels_r.cpu().numpy()
        with torch.inference_mode():
            postprocess_device(labels_r, cfg.min_component_voxels, cfg.et_min_voxels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = postprocess_device(labels_r, cfg.min_component_voxels,
                                     cfg.et_min_voxels)
            torch.cuda.synchronize()
            dev_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        want = postprocess_labels(labels_np,
                                  min_component_voxels=cfg.min_component_voxels,
                                  et_min_voxels=cfg.et_min_voxels)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool((got.cpu().numpy() == want).all()),
              f"device postprocessing equals host scipy on the ROI labels "
              f"{tuple(labels_np.shape)} ({int((labels_np > 0).sum())} "
              f"foreground voxels, {int((want != labels_np).sum())} changed)")
    print(f"  connected components + tiny-ET on the ROI: device median "
          f"{med(dev_ms):.3f} ms (all {[round(t, 3) for t in dev_ms]}), host "
          f"scipy median {med(host_ms):.3f} ms (all "
          f"{[round(t, 3) for t in host_ms]}) on {card}", flush=True)
    return {k: med(v) for k, v in out.items()}


def serve_slice(work, case_dirs, direct_masks, expect, serial_e2e, depth, card):
    """Phase 5 (see the module docstring). Returns the launch counts of the
    burst."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.infer import predictor as pmod
    from brats2019_tpu_torch.utils import profile

    root = os.path.join(WORK, "serve")
    watch, out, cache = (os.path.join(root, d) for d in ("watch", "out", "cache"))
    os.makedirs(watch)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    names = [os.path.basename(d) for d in case_dirs]
    common = ["--preset", PRESET, "--workdir", work, "--device", DEVICE,
              "--poll", "0.05"]

    def post_case(d, answers):
        req = urllib.request.Request(
            base + "/predict?format=json&timeout=300",
            data=json.dumps({"case_dir": d}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=330) as r:
            answers[d] = json.loads(r.read())

    def client(daemon_done):
        deadline = time.time() + 600
        health = {}
        while time.time() < deadline and not daemon_done.is_set():
            try:
                health = _get_json(base + "/healthz", timeout=5)
            except OSError:
                health = {}
            if health.get("warm"):
                break
            time.sleep(0.2)
        if not health.get("warm"):
            raise RuntimeError(f"the daemon never became warm: {health}")
        profile.clear()
        ops.reset_launch_counts()     # just before the main path is driven
        answers = {}
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post_case, args=(d, answers))
                   for d in case_dirs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(400)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()  # just after
        on_wgmma = ops.conv3d_winograd.launches_wgmma
        from_partials = ops.instance_norm_act.launches_partials
        results = {n: _get_json(base + f"/result?case={n}") for n in names}
        return {"answers": answers, "wall": wall, "counts": counts,
                "on_wgmma": on_wgmma, "from_partials": from_partials,
                "results": results, "stats": _get_json(base + "/stats"),
                "health": health}

    ops.set_backend("winograd")
    try:
        with profile.recording():
            rc, got = run_daemon(
                [watch, *common, "--output-dir", out, "--warmup", "--http",
                 str(port), "--prep-cache", cache, "--postproc", "device"], client)
    finally:
        ops.set_backend("direct")
    torch.cuda.synchronize()
    check(rc == 0, f"serve daemon drained cleanly after SIGTERM (exit code {rc})")
    answers, counts = got["answers"], got["counts"]
    check(len(answers) == len(case_dirs)
          and all(a.get("error") is None and a["case"] == os.path.basename(d)
                  for d, a in answers.items()),
          f"every POST /predict answered: {sorted(a['case'] for a in answers.values())}")
    log = serve_log(out)
    check(sorted(r["case"] for r in log) == sorted(names)
          and all(r.get("error") is None for r in log),
          f"serve_log.jsonl holds one clean record per case: "
          f"{[(r['case'], r['batch_size']) for r in log]}")
    check(all(got["results"][n].get("output", "").endswith(n + "_pred.nii.gz")
              for n in names) and got["stats"]["served"] == len(names)
          and got["stats"]["quarantined"] == 0,
          f"GET /result and /stats: {got['stats']}")
    n = len(case_dirs)
    print(f"  launches on the serving slice: {counts} (expected per volume: "
          f"conv3d_winograd {expect['conv3d']}, conv3d 0, "
          f"{ {k: v for k, v in expect.items() if k != 'conv3d'} })", flush=True)
    check(counts["conv3d_winograd"] == expect["conv3d"] * n and counts["conv3d"] == 0,
          f"conv3d_winograd launched {counts['conv3d_winograd']} times on the "
          f"serving slice ({expect['conv3d']} per volume), conv3d "
          f"{counts['conv3d']} times")
    check(got["on_wgmma"] == counts["conv3d_winograd"],
          f"{got['on_wgmma']} of the {counts['conv3d_winograd']} Winograd "
          f"launches took the wgmma instance (winograd3d_wgmma.cu)")
    for k in ("instance_norm_act", "downsample2x", "upsample2x"):
        check(counts[k] == expect[k] * n,
              f"{k} launched {counts[k]} times on the serving slice")
    check(got["from_partials"] == 0,
          f"{got['from_partials']} IN+act launches took partials on the "
          f"Winograd backend (it computes none: each IN takes its own statistics)")
    wino_masks = served_labels(out, case_dirs)
    for name, seg, ref in zip(names, wino_masks, direct_masks):
        vals = sorted(int(v) for v in set(seg.ravel().tolist()))
        agree = float((seg == ref).mean())
        fg = int(((seg > 0) | (ref > 0)).sum())
        check(seg.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4}
              and agree >= MASK_AGREE,
              f"{name} served: shape {seg.shape}, labels {vals}; voxel "
              f"agreement with phase 3's direct-conv mask {agree:.6f} (bound "
              f"{MASK_AGREE}; {int((seg != ref).sum())} of {fg} foreground "
              f"voxels differ)")
    span_ms = program_ms()
    burst = got["wall"]
    idle = 1.0 - sum(span_ms) / 1e3 / burst
    print(f"  burst of {n} over HTTP (serving depth {depth}, from the "
          f"preset): wall {burst:.3f} s = e2e {burst / n:.3f} s/vol pipelined "
          f"against {serial_e2e:.3f} s/vol one by one (phase 3); device program "
          f"spans {[round(v, 3) for v in span_ms]} ms (device postprocessing "
          f"and its host syncs inside), device idle share over the burst "
          f"{100 * idle:.1f}% on {card}", flush=True)
    check(len(span_ms) == n, f"{len(span_ms)} device programs ran in the burst")

    # a second daemon on the same output dir: the log replays, nothing is served
    rc, _ = run_daemon([watch, *common, "--output-dir", out, "--once",
                        "--postproc", "device", "--prep-cache", cache])
    check(rc == 0 and len(serve_log(out)) == n,
          f"second daemon over the same watch root and log served nothing "
          f"(exit code {rc}, {len(serve_log(out))} records)")

    # fresh logs: the same directories come from the payload cache, undecoded;
    # direct backend, host and device postprocessing: phase 3's masks bitwise
    decodes = []
    real_load_case = pmod.load_case
    pmod.load_case = lambda *a, **k: decodes.append(a) or real_load_case(*a, **k)
    try:
        for postproc in ("host", "device"):
            out2 = os.path.join(root, f"out_{postproc}")
            t0 = time.perf_counter()
            rc, _ = run_daemon([watch, *common, "--output-dir", out2, "--once",
                                "--postproc", postproc, "--prep-cache", cache])
            dt = time.perf_counter() - t0
            masks = served_labels(out2, case_dirs)
            same = [bool((a == b).all()) for a, b in zip(masks, direct_masks)]
            check(rc == 0 and all(same),
                  f"direct backend, --postproc {postproc}, pipelined: masks "
                  f"bitwise equal phase 3's {same} ({dt:.1f} s with start-up)")
    finally:
        pmod.load_case = real_load_case
    check(not decodes and len(os.listdir(cache)) == n,
          f"re-served cases hit the payload cache: {len(decodes)} NIfTI "
          f"decodes, {len(os.listdir(cache))} cache entries")
    return counts


# ------------------------------------------------------------------ phase 8 --

KD_STEPS = 12   # the KD run through the CLI: logged at 6 and 12; --profile traces 10-11
KD_TOL = 4e-3   # KD and total loss, kernel path vs the CPU plain path (bf16 both): 2^-8
REMAT = 2       # remat_levels of the deep-supervision step
REMAT_GRAD_TOL = 2e-2   # grads at remat 2 vs 0, max|d|/max|ref| per parameter


def foreign_state_dict(flat):
    """A torch state dict of ``flat``'s net under names that are not the
    port's (``net.<i>.conv<j>.weight`` OIDHW, ``net.<i>.norm<j>.{weight,
    bias}``, ``out.{weight,bias}``) in registration order: what a PyTorch
    checkpoint of the same topology trained elsewhere holds."""
    import numpy as np
    import torch

    oidhw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(4, 3, 0, 1, 2)))
    sd = {}
    blocks = sorted({k.split("/")[1] for k in flat if "/DoubleConv_" in k},
                    key=lambda b: int(b.split("_")[1]))
    for b in blocks:
        i = int(b.split("_")[1])
        for j in (0, 1):
            p = f"params/{b}/ConvNormAct_{j}/"
            sd[f"net.{i}.conv{j}.weight"] = oidhw(flat[p + "Conv_0/kernel"])
            sd[f"net.{i}.norm{j}.weight"] = torch.from_numpy(flat[p + "in_scale"].copy())
            sd[f"net.{i}.norm{j}.bias"] = torch.from_numpy(flat[p + "in_bias"].copy())
    sd["out.weight"] = oidhw(flat["params/head/kernel"])
    sd["out.bias"] = torch.from_numpy(flat["params/head/bias"].copy())
    return sd


class _Watch:
    """What the train CLI builds inside, for the checks of phase 8: the
    teachers (with their state at build time), each pool's first contents,
    the NIfTI decodes of the pool's prep, and the params at a run's first
    step. Installed on the port's module attributes for the phase, removed
    after it."""

    def __init__(self):
        self.teachers, self.pools, self.first_params = [], [], []
        self.decodes = 0
        self._undo = []

    def install(self):
        from brats2019_tpu_torch.data import pipeline
        from brats2019_tpu_torch.train import distill, loop
        from brats2019_tpu_torch.utils.weights import flat_from_state_dict

        watch = self
        build, load = distill.build_teachers, pipeline.load_case

        def build_teachers(*a, **k):
            ts = build(*a, **k)
            watch.teachers = [(t, {n: v.clone() for n, v in t.state_dict().items()})
                              for t in ts]
            return ts

        def load_case(*a, **k):
            watch.decodes += 1
            return load(*a, **k)

        class Pool(loop.CasePool):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                watch.pools.append((self.image.clone(), self.seg.clone(),
                                    self.fg_host.copy()))

        class Step(loop.TrainStep):
            def __call__(self, pool, step):
                if not getattr(self, "_seen", False):
                    self._seen = True
                    watch.first_params.append(flat_from_state_dict(
                        self.model.state_dict()))
                return super().__call__(pool, step)

        for mod, name, value in ((distill, "build_teachers", build_teachers),
                                 (pipeline, "load_case", load_case),
                                 (loop, "CasePool", Pool), (loop, "TrainStep", Step)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, value)

    def remove(self):
        for mod, name, value in reversed(self._undo):
            setattr(mod, name, value)
        self._undo.clear()


def kd_cli_run(exp, cases_root, t1, t2, root, watch, stage_fwd, stage_calls):
    """8.1 through the train CLI: ``--distill-from T1 T2`` at the flagship
    fine width, with ``--prep-cache --debug-checks --profile``: the log's
    kd_loss and total, the teachers bitwise unchanged, the student's routes
    (counters zeroed just before), the trace, the cache entries."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import train as train_cli

    sw = os.path.join(root, "student")
    cache = os.path.join(root, "prep_cache")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(train_cli.main, [
        "--data", cases_root, "--preset", "cascade", "--stage", "fine",
        "--device", "cuda", "--eval-every", "0", "--prep-cache", cache,
        "--workdir", sw, "--distill-from", t1, t2, "--steps", str(KD_STEPS),
        "--log-every", "6", "--checkpoint-every", "0", "--profile",
        "--debug-checks"])
    counts = ops.launch_counts()
    routes = {"conv3d.launches_wgmma": ops.conv3d.launches_wgmma,
              "conv3d.launches_stats": ops.conv3d.launches_stats,
              "instance_norm_act.launches_partials":
                  ops.instance_norm_act.launches_partials,
              "upsample2x.launches_concat": ops.upsample2x.launches_concat,
              "instance_norm_act_bwd.launches_cuda":
                  ops.instance_norm_act_bwd.launches_cuda,
              "upsample2x_bwd.launches_cuda": ops.upsample2x_bwd.launches_cuda}
    check(rc == 0, f"KD train CLI (--distill-from 2 teachers, {KD_STEPS} steps, "
                   f"--prep-cache --debug-checks --profile): exit code {rc} "
                   f"({time.perf_counter() - t0:.1f} s)")
    t = exp.train
    with open(os.path.join(sw, "fine", "fine_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if '"loss"' in line]
    sums = []
    for r in recs:
        gt = (t.dice_weight * r["dice_loss"] + t.ce_weight * r["ce_loss"]
              + t.region_weight * r.get("region_dice_loss", 0.0))
        sums.append(abs(r["loss"] - (gt + r["kd_loss"])) / abs(r["loss"]))
    check([r["step"] for r in recs] == [6, KD_STEPS]
          and all(math.isfinite(r["kd_loss"]) and r["kd_loss"] > 0
                  and r["grad_norm"] > 0 for r in recs) and max(sums) <= 1e-5,
          f"KD log: steps {[r['step'] for r in recs]}, kd_loss "
          f"{[round(r['kd_loss'], 6) for r in recs]}, loss "
          f"{[round(r['loss'], 6) for r in recs]} = 1.0 gt + 1.0 kd within "
          f"{max(sums):.2e} (tol 1e-5)")
    same = [all(torch.equal(v, before[n]) for n, v in tm.state_dict().items())
            for tm, before in watch.teachers]
    check(len(same) == 2 and all(same),
          f"the two teachers' params bitwise unchanged after the run: {same}")
    # per KD step: the student's forward and backward, two teacher forwards
    want = {k: KD_STEPS * (sum(1 for n, _ in stage_calls if n == k)
                           + 2 * sum(1 for n, _ in stage_fwd if n == k))
            for k in KERNELS if k != "conv3d_winograd"}
    fwd_convs = KD_STEPS * 3 * sum(1 for n, _ in stage_fwd if n == "conv3d")
    fwd_in = KD_STEPS * 3 * sum(1 for n, _ in stage_fwd if n == "instance_norm_act")
    want_routes = {"conv3d.launches_wgmma": want["conv3d"],
                   "conv3d.launches_stats": fwd_convs,
                   "instance_norm_act.launches_partials": fwd_in,
                   "upsample2x.launches_concat": want["upsample2x"],
                   "instance_norm_act_bwd.launches_cuda": want["instance_norm_act_bwd"],
                   "upsample2x_bwd.launches_cuda": want["upsample2x_bwd"]}
    got = {k: counts[k] for k in want}
    check(got == want and routes == want_routes,
          f"KD run launches {got} (expected {want}); routes {routes} (expected "
          f"{want_routes}): the wgmma conv with its statistics epilogue, IN from "
          f"its partials, the CUDA C++ up and backwards, on every call")
    check("--debug-checks: pool sampling bounds OK" in out,
          "--debug-checks ran the sampler's bounds checks at start-up")
    trace = os.path.join(sw, "fine", "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(len(kernels) > 0, f"--profile on train: {trace} holds {len(events)} "
                            f"events, {len(kernels)} device kernels")
    entries = sorted(os.listdir(cache))
    check(len(entries) >= 1 and all(e.endswith(".npz") for e in entries),
          f"--prep-cache wrote {len(entries)} entries: {entries}")
    return counts


def kd_against_plain(exp, tparams, dev):
    """8.1: one batch's KD loss on the kernel path on the card against the
    port's plain path (the CPU) on the same weights (bf16 both), at
    STEP_REF_PATCH."""
    import dataclasses

    import torch

    from brats2019_tpu_torch.train import distill
    from brats2019_tpu_torch.utils.weights import build_unet, init_params

    cfg = dataclasses.replace(exp.train, patch=STEP_REF_PATCH)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, *STEP_REF_PATCH, 4), generator=g)
    y = torch.randint(0, 4, (1, *STEP_REF_PATCH), generator=g)
    sparams = init_params(exp.unet, SEED + 2)
    got = {}
    for where in (dev, "cpu"):
        student = build_unet(exp.unet, sparams, where)
        teachers = distill.build_teachers(exp.unet, tparams, where)
        loss_fn = distill.make_kd_microbatch_loss(
            distill.teacher_replicas(teachers, [where]), cfg, distill.KDConfig())
        with torch.no_grad():
            loss, aux = loss_fn(student, x.to(where), y.to(where))
        got[str(where)] = (float(loss), float(aux["kd_loss"]))
    (l_dev, kd_dev), (l_cpu, kd_cpu) = got[str(dev)], got["cpu"]
    rl, rk = abs(l_dev - l_cpu) / abs(l_cpu), abs(kd_dev - kd_cpu) / abs(kd_cpu)
    check(rl <= KD_TOL and rk <= KD_TOL,
          f"KD loss of one batch {STEP_REF_PATCH}, kernel path vs plain path "
          f"(bf16): total {l_dev:.6f} vs {l_cpu:.6f} (rel {rl:.2e}), kd "
          f"{kd_dev:.6f} vs {kd_cpu:.6f} (rel {rk:.2e}); tol {KD_TOL:g}")


def time_kd(exp, tparams, dev, card):
    """8.1: KD step ms against the plain fine step in this process (CUDA
    events, 10 steps after 3 warm-up each, the same random pool), patches/s,
    MFU (the teachers' forwards counted), peak memory, and a profile of the
    KD step (device kernel time, idle share). Returns the numbers."""
    import torch

    from brats2019_tpu_torch.train import distill
    from brats2019_tpu_torch.train.loop import init_stage, stage_config
    from brats2019_tpu_torch.train.step import TrainStep, make_microbatch_loss
    from brats2019_tpu_torch.utils.flops import mfu, train_step_flops, unet_forward_flops

    ucfg, cfg, _ = stage_config(exp, "fine")
    pool = random_pool(cfg, dev)
    name = torch.cuda.get_device_name(0)
    out = {}
    for what in ("plain", "kd"):
        model, opt = init_stage(ucfg, cfg, dev)
        if what == "kd":
            teachers = distill.build_teachers(ucfg, tparams, dev)
            loss_fn = distill.make_kd_microbatch_loss(
                distill.teacher_replicas(teachers, [dev]), cfg, distill.KDConfig())
            flops = (train_step_flops(ucfg, cfg) + len(teachers) * cfg.batch_per_device
                     * unet_forward_flops(ucfg, tuple(cfg.patch)))
        else:
            loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
            flops = train_step_flops(ucfg, cfg)
        step = TrainStep(model, cfg, loss_fn, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, aux = timed_steps(step, pool)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        m = mfu(flops, ms / 1e3, name)
        out[what] = (ms, m, peak)
        check(math.isfinite(float(aux["loss"])),
              f"{what} fine step timed: loss {float(aux['loss']):.4f}")
        print(f"  {what} fine train step {ms:.3f} ms (CUDA events, mean of 10 after "
              f"3 warm-up), {cfg.batch_per_device * 1e3 / ms:.2f} patches/s, MFU "
              f"{'n/a' if m is None else f'{100 * m:.2f}%'} ({flops / 1e12:.3f} "
              f"TFLOP/step), peak device memory {peak:.3f} GiB above what was "
              f"allocated before the steps (model, pool) on {card}", flush=True)
        if what == "kd":
            profile_steps(step, pool, "kd", 13, 3, ms)
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def remat_step(exp, dev, card):
    """8.2: one fine step's loss and backward with deep supervision at
    remat_levels 0 and REMAT on the same weights and batch: losses bitwise
    equal, grads within REMAT_GRAD_TOL (and whether bitwise), the
    recomputed levels' forward kernels launched twice, peak device memory
    and ms of each."""
    import dataclasses

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.train.loop import init_stage, stage_config
    from brats2019_tpu_torch.train.step import make_microbatch_loss

    ucfg, cfg, _ = stage_config(exp, "fine")
    ds = dataclasses.replace(ucfg, deep_supervision=True)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((1, *cfg.patch, 4), generator=g, device=dev)
    y = torch.randint(0, 4, (1, *cfg.patch), generator=g, device=dev)
    loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True,
                                   deep_supervision=True)
    runs = {}
    for r in (0, REMAT):
        model, _ = init_stage(dataclasses.replace(ds, remat_levels=r), cfg, dev)
        for _ in range(2):                     # warm-up, then the measured run
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()   # the process's, the weights'
            ops.reset_launch_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss, _ = loss_fn(model, x, y)
            loss.backward()
            ev[1].record()
            torch.cuda.synchronize()
        runs[r] = (loss.detach().clone(), ops.launch_counts(), ops.conv3d.launches_stats,
                   {n: p.grad.float().clone() for n, p in model.named_parameters()},
                   (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                   ev[0].elapsed_time(ev[1]))
        del model
        torch.cuda.empty_cache()
    (l0, c0, s0, g0, m0, t0), (l2, c2, s2, g2, m2, t2) = runs[0], runs[REMAT]
    rel = {n: ((g2[n] - g0[n]).abs().max() / g0[n].abs().max().clamp_min(1e-30)).item()
           for n in g0}
    bitwise = all(torch.equal(g2[n], g0[n]) for n in g0)
    blocks = 2 * REMAT                       # the encoder's and decoder's blocks
    twice = {k: c2[k] - c0[k] for k in ("conv3d", "instance_norm_act")}
    check(torch.equal(l0, l2) and max(rel.values()) <= REMAT_GRAD_TOL
          and twice == {"conv3d": 2 * blocks, "instance_norm_act": 2 * blocks}
          and s2 - s0 == 2 * blocks
          and all(c2[k] == c0[k] for k in BACKWARD),
          f"deep supervision, remat_levels {REMAT} vs 0 (patch {cfg.patch}): loss "
          f"{float(l2):.6f} vs {float(l0):.6f} bitwise equal {torch.equal(l0, l2)}; "
          f"grads max|d|/max|ref| {max(rel.values()):.3e} (tol {REMAT_GRAD_TOL:g}), "
          f"bitwise equal (cuDNN wgrad deterministic here): {bitwise}; forward "
          f"kernels launched again {twice} (expected {2 * blocks} each, "
          f"{s2 - s0} with the statistics epilogue), backward launches equal")
    print(f"  deep-supervision fine step (loss + backward, patch {cfg.patch}): "
          f"remat 0 {t0:.3f} ms, peak {m0:.3f} GiB; remat {REMAT} {t2:.3f} ms, "
          f"peak {m2:.3f} GiB (peak device memory above what was allocated "
          f"before the step) on {card}", flush=True)
    return {0: (t0, m0), REMAT: (t2, m2)}


def warm_start_runs(exp, cases_root, root, watch):
    """8.3: ``--init-from`` an ``.npz``, a ``.safetensors`` and a foreign
    ``.pt`` at the flagship fine width: step-0 params equal the file's,
    each run's pool comes from the prep cache (no NIfTI decode) and equals
    the KD run's first pool; then a second run in the .pt workdir resumes
    and prints the "IGNORED" note."""
    import numpy as np
    import torch

    from brats2019_tpu_torch.cli import train as train_cli
    from brats2019_tpu_torch.utils.weights import init_params, save_params

    src = init_params(exp.unet, SEED + 3)
    paths = {ext: os.path.join(root, f"warm_src.{ext}") for ext in ("npz", "safetensors")}
    for p in paths.values():
        save_params(p, src)
    paths["pt"] = os.path.join(root, "warm_src.pt")
    torch.save(foreign_state_dict(src), paths["pt"])
    first_pool = watch.pools[0]
    base = ["--data", cases_root, "--preset", "cascade", "--stage", "fine",
            "--device", "cuda", "--eval-every", "0", "--log-every", "1",
            "--checkpoint-every", "1",
            "--prep-cache", os.path.join(root, "prep_cache")]
    for ext, path in paths.items():
        wd = os.path.join(root, f"warm_{ext}")
        watch.first_params.clear()
        watch.decodes = 0
        n_pools = len(watch.pools)
        t0 = time.perf_counter()
        rc, out = run_cli(train_cli.main, base + ["--workdir", wd, "--init-from",
                                                  path, "--steps", "1"])
        p0 = watch.first_params[0] if watch.first_params else {}
        same = p0.keys() == src.keys() and all(np.array_equal(p0[k], src[k]) for k in src)
        pool = watch.pools[n_pools] if len(watch.pools) > n_pools else None
        pool_same = pool is not None and all(
            (torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b))
            for a, b in zip(pool, first_pool))
        check(rc == 0 and "warm-started params from" in out and same,
              f"--init-from {ext}: exit code {rc}, step-0 params equal the file's: "
              f"{same} ({time.perf_counter() - t0:.1f} s)")
        check(watch.decodes == 0 and pool_same,
              f"--prep-cache on train ({ext} run): {watch.decodes} NIfTI decodes "
              f"for the pool, its bytes equal the first run's: {pool_same}")
    rc, out = run_cli(train_cli.main, base + ["--workdir", os.path.join(root, "warm_pt"),
                                              "--init-from", paths["pt"], "--steps", "2"])
    check(rc == 0 and "IGNORED" in out and "resumed from step 1" in out,
          f"a second --init-from run in the same workdir resumes from step 1 and "
          f"prints the IGNORED note: exit code {rc}")


def import_and_predict(case_dir, root):
    """8.3: ``cli.import_torch`` of a foreign ``.pt`` of the
    ``reference_parity`` topology (the importer refuses the space-to-depth
    presets) into a workdir, then ``cli.predict --profile`` of one phase-3
    case from it on the card."""
    import numpy as np
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import import_torch as import_cli
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.utils.nifti import read_nifti
    from brats2019_tpu_torch.utils.weights import init_params, load_params

    rp = get_preset("reference_parity")
    src = init_params(rp.unet, SEED + 4)
    pt = os.path.join(root, "reference_parity.pt")
    torch.save(foreign_state_dict(src), pt)
    wd = os.path.join(root, "imported")
    rc = import_cli.main([pt, "--preset", "reference_parity", "--workdir", wd])
    got = load_params(os.path.join(wd, "fine", "params.npz")) if rc == 0 else {}
    same = got.keys() == src.keys() and all(np.array_equal(got[k], src[k]) for k in src)
    check(rc == 0 and same, f"import_torch of a foreign reference_parity .pt: exit "
                            f"code {rc}, params equal the source: {same}")
    out = os.path.join(root, "imported_pred.nii.gz")
    prof = os.path.join(root, "predict_profile")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = predict_cli.main([case_dir, "--preset", "reference_parity", "--workdir", wd,
                           "--device", "cuda", "--output", out, "--profile", prof])
    convs = ops.conv3d.launches
    seg = read_nifti(out, apply_scaling=False)[0] if rc == 0 else None
    check(rc == 0 and seg.shape == VOLUME_SHAPE and set(np.unique(seg)) <= {0, 1, 2, 4}
          and convs > 0,
          f"predict from the imported workdir on the card: exit code {rc}, shape "
          f"{None if seg is None else seg.shape}, {convs} conv launches "
          f"({time.perf_counter() - t0:.1f} s)")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, f"--profile on predict: {len(events)} events, {kernels} "
                       f"device kernels")


def info_on_card():
    """8.4: ``cli.info`` reports the card."""
    import torch

    from brats2019_tpu_torch.cli import info as info_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = info_cli.main(["--preset", "cascade"])
    doc = json.loads(buf.getvalue())
    cuda = doc["torch"]["cuda"]
    dev0 = (cuda.get("devices") or [{}])[0]
    check(rc == 0 and cuda["available"] and cuda["device_count"] == torch.cuda.device_count()
          and dev0.get("name") == torch.cuda.get_device_name(0)
          and dev0.get("capability") == list(torch.cuda.get_device_capability(0)),
          f"cli.info reports the card: {cuda}, nvcc {doc['kernels']['nvcc']}")


def training_leftouts(exp, cases_root, case_dirs, dev, card, stage_fwd, stage_calls):
    """Phase 8: the training left-outs at the flagship fine width (module
    docstring). Teachers: phase 4's cascade workdir and a second from
    seed + 1 exported through the weight bridge."""
    import dataclasses

    from brats2019_tpu_torch.cli.common import load_stage_params
    from brats2019_tpu_torch.utils.weights import init_params, load_params, save_params

    root = os.path.join(WORK, "leftouts")
    t1 = os.path.join(WORK, "train_workdir")
    t2 = os.path.join(root, "teacher2")
    os.makedirs(os.path.join(t2, "fine"))
    save_params(os.path.join(t2, "fine", "params.npz"), init_params(exp.unet, SEED + 1))
    tparams = [load_stage_params(dataclasses.replace(exp, workdir=t1), "fine"),
               load_params(os.path.join(t2, "fine", "params.npz"))]
    watch = _Watch()
    watch.install()
    try:
        kd_cli_run(exp, cases_root, t1, t2, root, watch, stage_fwd, stage_calls)
        warm_start_runs(exp, cases_root, root, watch)
    finally:
        watch.remove()
    kd_against_plain(exp, tparams, dev)
    kd = time_kd(exp, tparams, dev, card)
    mem = remat_step(exp, dev, card)
    import_and_predict(case_dirs[0], root)
    info_on_card()
    (p_ms, _, p_peak), (k_ms, k_mfu, k_peak) = kd["plain"], kd["kd"]
    print(f"  phase 8 summary on {card}: KD step (2 teachers) {k_ms:.3f} ms, "
          f"{1e3 / k_ms:.2f} patches/s, MFU "
          f"{'n/a' if k_mfu is None else f'{100 * k_mfu:.2f}%'}, peak {k_peak:.2f} GiB, "
          f"against the plain fine step {p_ms:.3f} ms (peak {p_peak:.2f} GiB); "
          f"deep-supervision step's own peak memory remat 0 {mem[0][1]:.3f} GiB, "
          f"remat {REMAT} {mem[REMAT][1]:.3f} GiB ({mem[0][0]:.3f} vs "
          f"{mem[REMAT][0]:.3f} ms)",
          flush=True)



# ------------------------------------------------------------------ phase 9 --

MESH_SIZES = (2, 4)   # shards of one card: ["cuda:0"] * n
# a label that differs from the single-device program's must sit on a tie:
# the single-device probabilities' top-2 gap there at most this (the TTA
# probabilities are stored in bf16: 2^-7 is one bf16 step just below 1.0,
# and the mesh's per-shard batches may round a logit differently)
TIE_GAP = 2 ** -6
# bf16 spatial logits vs the one-shard spatial route and vs the unsharded
# model's forward (whose IN statistics come from the conv's epilogue):
# phase 2's conv bound. Both read 7.2-8.7e-3, the same to the last digit in
# every run (deterministic kernels, seeded data): bf16 rounding along 14
# layers, which the shards' other conv plans and statistics merge order
# change (PERF.md section 6)
SPATIAL_TOL = 1e-2
# the same at f32 compute: the spatial forward's bound in the CPU tests
SPATIAL_F32_TOL = 1e-4
# postprocessed mesh masks vs phase 3's: the reference's own bar for its
# mesh cascade against its single-device predictor
# (tests/test_multichip_cli.py: agreement > 0.999)
MESH_MASK_AGREE = 0.999
# f32 grads of the fine net at full width (random init) cancel so far that
# two f32 runs of the same grads lie ~1e-3 apart in relative L2, while in
# f64 the batch of 2 and the mean of two batches of 1 agree exactly (the
# loss is a mean over samples). ``tools/torch_dp_check.py --f64`` measured
# each f32 run's distance from the f64 grads on the card; the sum of two
# runs' distances bounds their distance from each other. The sums it read on
# an H100 (PERF.md section 6): the fine step 5.31e-3 at 64^3 and 3.19e-3 at
# 128^3; the whole-volume grads, unsharded and over 2 shards, 5.09e-3 at
# 64^3. Each tolerance is the larger sum of its kind, rounded up.
# The data-parallel step's averaged grads vs the one-shard step on the
# concatenated batch (128^3 patches):
DP_GRAD_TOL = 6e-3
# vs the mean of the one-shard grads of each shard's own batch: the same
# kernels at the same shapes, so only the averaging's own rounding
DP_SHARD_TOL = 1e-6
# make_spatial_train_grad over 2 shards vs the unsharded model, f32, one
# SPATIAL_TRAIN_EDGE^3 volume:
SPATIAL_TRAIN_EDGE = 64
SPATIAL_GRAD_TOL = 6e-3
MP_LOSS_RTOL = 1e-5   # multi-process losses vs one process of two shards


@contextlib.contextmanager
def native_decoder(on: bool):
    """The native NIfTI decoder on (as it is) or off (``available()`` False:
    ``load_case(backend="auto")`` takes the NumPy reader)."""
    from brats2019_tpu_torch.utils import nifti_fast

    real = nifti_fast.available
    if not on:
        nifti_fast.available = lambda: False
    try:
        yield
    finally:
        nifti_fast.available = real


def program_ms():
    """The device time of each ``predict.program`` span the recorder kept
    (``utils/profile.py``), by its CUDA-event edges, ms."""
    from brats2019_tpu_torch.utils import profile

    return [s.device_ms for s in profile.snapshot()
            if s.name == "predict.program" and s.device_ms is not None]


def burst(argv, case_dirs, one_scan=False):
    """One daemon (``argv``: the watch root, then flags; ``--warmup --http
    PORT`` added): every case POSTed at once once it is warm, the launch
    counters zeroed just before and read just after. With ``one_scan`` the
    burst waits for the deferred warmup arms too, and the client links every
    case into the watch root itself (the link a co-located POST makes) while
    it holds the daemon's scans off, so that one scan sees the whole burst
    and it is served as one batch. The device idle share is the burst's wall
    less the device time of the program's ``predict.program`` spans
    (``utils/profile.py``, recorded here). Returns (rc, e2e s/vol, device
    idle share, counts, answers)."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import serve as serve_cli
    from brats2019_tpu_torch.utils import profile

    port = _free_port()
    base = f"http://127.0.0.1:{port}"

    def post_case(d, answers):
        req = urllib.request.Request(
            base + "/predict?format=json&timeout=300",
            data=json.dumps({"case_dir": d}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=330) as r:
            answers[d] = json.loads(r.read())

    def client(daemon_done):
        deadline = time.time() + 600
        health = {}
        while time.time() < deadline and not daemon_done.is_set():
            try:
                health = _get_json(base + "/healthz", timeout=5)
            except OSError:
                health = {}
            if health.get("warm"):
                break
            time.sleep(0.2)
        if not health.get("warm"):
            raise RuntimeError(f"the daemon never became warm: {health}")
        if one_scan and not rest_done.wait(120):
            raise RuntimeError("the daemon's deferred warmup never ran")
        profile.clear()
        ops.reset_launch_counts()
        answers = {}
        t0 = time.perf_counter()
        if one_scan:
            with scan_lock:
                for d in case_dirs:
                    os.symlink(d, os.path.join(argv[0], os.path.basename(d)))
        threads = [threading.Thread(target=post_case, args=(d, answers))
                   for d in case_dirs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(400)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        counts["conv3d_winograd.launches_wgmma"] = ops.conv3d_winograd.launches_wgmma
        return {"answers": answers, "wall": wall, "counts": counts}

    rest_done, scan_lock = threading.Event(), threading.Lock()
    real_rest, real_scan = serve_cli.Server._finish_warmup_rest, serve_cli.Server.scan

    def rest(self):
        real_rest(self)
        rest_done.set()

    def scan(self, *a):
        with scan_lock:
            return real_scan(self, *a)

    patched = {"_finish_warmup_rest": rest, "scan": scan} if one_scan else {}
    real = {k: getattr(serve_cli.Server, k) for k in patched}
    for k, f in patched.items():
        setattr(serve_cli.Server, k, f)
    try:
        with profile.recording():
            rc, got = run_daemon([*argv, "--warmup", "--http", str(port)], client)
    finally:
        for k, f in real.items():
            setattr(serve_cli.Server, k, f)
    torch.cuda.synchronize()
    n = len(case_dirs)
    span_s = sum(program_ms()) / 1e3
    return rc, got["wall"] / n, 1.0 - span_s / got["wall"], got["counts"], got["answers"]


def decoder_slice(exp, work, case_dirs, card):
    """9.1: the native decoder is built and bitwise the NumPy reader on the
    phase-3 cases; one-by-one e2e and the phase-5 burst with and without it,
    in turns, in this call."""
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.data.preprocess import brain_bbox_np
    from brats2019_tpu_torch.infer import predictor as pmod
    from brats2019_tpu_torch.utils import nifti_fast

    ok = nifti_fast.available()
    check(ok, f"native NIfTI decoder built and loaded "
              f"({nifti_fast.library_path().name if ok else nifti_fast.build_error})")
    if not ok:
        return None
    for d in case_dirs:
        t0 = time.perf_counter()
        a = load_case(d, load_seg=True, backend="native")
        t1 = time.perf_counter()
        b = load_case(d, load_seg=True, backend="python")
        t2 = time.perf_counter()
        bb = brain_bbox_np(b.image)
        same = (a.image.tobytes() == b.image.tobytes()
                and a.seg.tobytes() == b.seg.tobytes()
                and a.header.raw == b.header.raw)
        box = (tuple(int(v) for v in a.meta["bbox_lo"]),
               tuple(int(v) for v in a.meta["bbox_hi"]))
        check(same and box == (bb.lo, bb.hi),
              f"{os.path.basename(d)}: native decode bitwise the NumPy "
              f"reader's ({same}), meta bbox {box} = scan {(bb.lo, bb.hi)}; "
              f"decode {t1 - t0:.3f} s native, {t2 - t1:.3f} s NumPy")
    pred = pmod.Predictor(exp, os.path.join(work, "fine", "params.npz"),
                          os.path.join(work, "coarse", "params.npz"),
                          device="cuda")
    tmp_out = os.path.join(work, "timed_pred9.nii.gz")
    pred.predict_dir(case_dirs[0], tmp_out)
    e2e = {True: [], False: []}
    for on in (True, False, True, False):
        with native_decoder(on):
            for d in case_dirs:
                t0 = time.perf_counter()
                pred.predict_dir(d, tmp_out)
                e2e[on].append(time.perf_counter() - t0)
    med = lambda v: sorted(v)[len(v) // 2]
    root = os.path.join(WORK, "decoder_burst")
    bursts = {}
    from brats2019_tpu_torch import ops

    for on in (True, False):
        watch = os.path.join(root, f"watch_{on}")
        os.makedirs(watch)
        ops.set_backend("winograd")
        try:
            with native_decoder(on):
                rc, s_vol, idle, _, answers = burst(
                    [watch, "--preset", PRESET, "--workdir", work, "--device",
                     DEVICE, "--poll", "0.05", "--output-dir",
                     os.path.join(root, f"out_{on}"), "--prep-cache",
                     os.path.join(root, f"cache_{on}"), "--postproc", "device"],
                    case_dirs)
        finally:
            ops.set_backend("direct")
        check(rc == 0 and len(answers) == len(case_dirs)
              and all(a.get("error") is None for a in answers.values()),
              f"phase-5 burst with the decoder {'on' if on else 'off'}: "
              f"exit code {rc}, {len(answers)} answers")
        bursts[on] = (s_vol, idle)
    print(f"  e2e s/vol one by one (phase 3's path), native decoder: median "
          f"{med(e2e[True]):.3f} (all {[round(v, 3) for v in e2e[True]]}); "
          f"NumPy reader: median {med(e2e[False]):.3f} (all "
          f"{[round(v, 3) for v in e2e[False]]}), in turns, on {card}",
          flush=True)
    print(f"  phase-5 burst of {len(case_dirs)} (Winograd backend, fresh "
          f"payload cache, device postprocessing): native decoder "
          f"{bursts[True][0]:.3f} s/vol, device idle {100 * bursts[True][1]:.1f}%; "
          f"NumPy reader {bursts[False][0]:.3f} s/vol, device idle "
          f"{100 * bursts[False][1]:.1f}% on {card}", flush=True)
    return {"e2e": {k: med(v) for k, v in e2e.items()}, "burst": bursts}


def export_slice(cases_root, card):
    """9.2: ``unit`` trained on the card with --ema-decay, exported with
    --ema and --average 2, each export loaded by predict."""
    import numpy as np

    from brats2019_tpu_torch.cli import export as export_cli
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.cli import train as train_cli
    from brats2019_tpu_torch.train.checkpoint import CheckpointManager
    from brats2019_tpu_torch.utils.weights import load_params

    work = os.path.join(WORK, "export")
    t0 = time.perf_counter()
    rc, _ = run_cli(train_cli.main, [
        "--preset", "unit", "--data", cases_root, "--workdir", work,
        "--device", "cuda", "--steps", "4", "--checkpoint-every", "1",
        "--ema-decay", "0.6"])
    check(rc == 0, f"unit trained on the card with --ema-decay (exit code {rc}, "
                   f"{time.perf_counter() - t0:.1f} s)")
    ckpt = CheckpointManager(os.path.join(work, "fine"))
    latest = ckpt.restore()
    pred_out = os.path.join(work, "pred.nii.gz")
    case = os.path.join(cases_root, sorted(os.listdir(cases_root))[0])
    for how in (["--ema"], ["--average", "2"]):
        rc, _ = run_cli(export_cli.main, ["--preset", "unit", "--workdir", work,
                                          *how])
        got = load_params(os.path.join(work, "fine", "params.npz"))
        if how == ["--ema"]:
            want = {"params/" + k.replace(".", "/"): v.numpy()
                    for k, v in latest["opt_state"]["ema"].items()}
        else:
            a, b = (ckpt.restore_params_at(s) for s in ckpt.all_steps()[-2:])
            want = {k: np.asarray((a[k].astype(np.float32)
                                   + b[k].astype(np.float32)) * 0.5, a[k].dtype)
                    for k in a}
        same = got.keys() == want.keys() and all(
            np.array_equal(got[k], want[k]) for k in want)
        prc, out = run_cli(predict_cli.main, [case, "--preset", "unit",
                                              "--workdir", work, "--device",
                                              "cuda", "--output", pred_out])
        check(rc == 0 and same and prc == 0 and os.path.exists(pred_out),
              f"export {' '.join(how)}: exit code {rc}, the exported tensors "
              f"equal the {'tracker' if how == ['--ema'] else 'mean of steps ' + str(ckpt.all_steps()[-2:])}"
              f" ({same}); predict loads it (exit code {prc})")
        os.remove(pred_out)


def _route_counts():
    from brats2019_tpu_torch import ops

    return {
        "conv3d": ops.conv3d.launches,
        "conv3d on conv3d_wgmma.cu": ops.conv3d.launches_wgmma,
        "instance_norm_act": ops.instance_norm_act.launches,
        "shard statistics passes": ops.instance_norm_act.launches_shard_stats,
        "downsample2x": ops.downsample2x.launches,
        "upsample2x": ops.upsample2x.launches,
        "upsample2x on resize2x.cu": ops.upsample2x.launches_cuda,
        "upsample2x into the concat": ops.upsample2x.launches_concat,
        "conv3d_winograd": ops.conv3d_winograd.launches,
    }


def _expected_routes(cfg_counts, spatial=False):
    """The route counters a run of ``cfg_counts`` (list of (unet_calls list,
    forwards)) must show."""
    want = {"conv3d": 0, "instance_norm_act": 0, "downsample2x": 0,
            "upsample2x": 0}
    for calls, times in cfg_counts:
        for k in want:
            want[k] += times * sum(1 for n, _ in calls if n == k)
    return {
        "conv3d": want["conv3d"],
        "conv3d on conv3d_wgmma.cu": want["conv3d"],
        "instance_norm_act": want["instance_norm_act"],
        "shard statistics passes": want["instance_norm_act"] if spatial else 0,
        "downsample2x": want["downsample2x"],
        "upsample2x": want["upsample2x"],
        "upsample2x on resize2x.cu": want["upsample2x"],
        "upsample2x into the concat": want["upsample2x"],
        "conv3d_winograd": 0,
    }


def _tie_check(what, got, ref, probs):
    """Labels equal except where the reference probabilities' top-2 gap is
    within TIE_GAP."""
    import numpy as np

    diff = got != ref
    n = int(diff.sum())
    gap = 0.0
    if n:
        s = np.sort(probs[diff], axis=-1)
        gap = float((s[:, -1] - s[:, -2]).max())
    check(n == 0 or gap <= TIE_GAP,
          f"{what}: {n} of {got.size} voxels differ from the single-device "
          f"program's labels, largest top-2 gap there {gap:.2e} (ties: <= "
          f"{TIE_GAP:.2e})")
    return n


def check_shard_statistics(exp, dev):
    """The spatial mode's IN route against its plain version: each shard's
    statistics pass (``ops.instance_norm_partials``) of the flagship fine
    net's top-level activation split on X into 2 and 4 shards, all partials
    merged by the IN kernel on each shard: each shard's IN+act within 2 bf16
    ulp of its slice of the whole volume's plain IN+act."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.ops import norm

    r = exp.unet.stem_downsample
    shape = (1,) + tuple(c // r for c in exp.infer.canvas) + (exp.unet.feats(0),)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=g, device=dev) * 0.1
    ref = norm.instance_norm_act_plain(x, gam, bet, activation="relu")
    for n in MESH_SIZES:
        slices = [s.contiguous() for s in x.tensor_split(n, dim=1)]
        every = torch.cat([ops.instance_norm_partials(s) for s in slices], 2)
        got = torch.cat([ops.instance_norm_act(s, gam, bet, activation="relu",
                                               partials=every) for s in slices], 1)
        u = bf16_ulps(got, ref)
        check(u <= 2, f"IN+act of {n} shards of {shape} from their merged "
                      f"statistics passes vs the whole volume's plain IN+act: "
                      f"{u:.2f} bf16 ulp (tol 2)")


def mesh_modes(exp, work, case_dirs, first, dev, card):
    """9.3: the three --multichip modes on the flagship cascade preset at
    full width, on meshes of 2 and 4 shards of the card."""
    import dataclasses

    import numpy as np
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.data.constants import disk_to_internal
    from brats2019_tpu_torch.data.preprocess import (brain_bbox_fast_np,
                                                     crop_cast_fit_np, zscore)
    from brats2019_tpu_torch.infer.multichip import MultichipPredictor
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.infer.tiling import tile_origins
    from brats2019_tpu_torch.parallel.mesh import make_mesh
    from brats2019_tpu_torch.parallel.spatial_unet import make_spatial_unet
    from brats2019_tpu_torch.utils.weights import build_unet

    pf = os.path.join(work, "fine", "params.npz")
    pc = os.path.join(work, "coarse", "params.npz")
    raw = dataclasses.replace(exp, infer=dataclasses.replace(
        exp.infer, min_component_voxels=0, et_min_voxels=0, postproc="host"))
    single_stage = dataclasses.replace(raw, infer=dataclasses.replace(
        raw.infer, cascade=False))
    images = [load_case(d).image for d in case_dirs]
    casc_ref = Predictor(raw, pf, pc, device=dev)
    sweep_ref = Predictor(single_stage, pf, device=dev)
    refs = {"cascade": [(casc_ref.predict_arrays(im)[0],
                         casc_ref.predict_probs_arrays(im)[0]) for im in images],
            "sweep": [(sweep_ref.predict_arrays(images[0])[0],
                       sweep_ref.predict_probs_arrays(images[0])[0])]}
    del casc_ref, sweep_ref
    canvas = tuple(exp.infer.canvas)
    net32 = build_unet(dataclasses.replace(exp.unet, compute_dtype="float32"),
                       pf, dev)
    fine_calls = unet_calls(exp.unet, 1, exp.infer.tile)
    coarse_calls = unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
    med = lambda v: sorted(v)[len(v) // 2]
    ms = {}
    for n in MESH_SIZES:
        env = make_mesh(["cuda:0"] * n)
        # cascade: the coarse net once (one card), one fine forward a shard
        mp = MultichipPredictor(exp, pf, mode="cascade", env=env, params_coarse=pc)
        mp_raw = MultichipPredictor(raw, pf, mode="cascade", env=env,
                                    params_coarse=pc)
        mp_raw.warmup()
        ops.reset_launch_counts()
        got = [mp_raw.predict_arrays(im) for im in images]
        routes = _route_counts()
        want = _expected_routes([(coarse_calls, len(images)),
                                 (fine_calls, n * len(images))])
        check(routes == want, f"cascade mode, {n} shards: routes {routes} "
                              f"(expected {want})")
        for i, (g, (ref, probs)) in enumerate(zip(got, refs["cascade"])):
            _tie_check(f"cascade mode, {n} shards, case {i}", g, ref, probs)
        for i, (im, seg) in enumerate(zip(images, first)):
            post = mp.predict_arrays(im)
            agree = float((post == disk_to_internal(seg)).mean())
            check(agree > MESH_MASK_AGREE,
                  f"cascade mode, {n} shards, case {i}, postprocessed: "
                  f"agreement with phase 3's mask {agree:.7f} "
                  f"({int((post != disk_to_internal(seg)).sum())} voxels; "
                  f"bound {MESH_MASK_AGREE})")
        # sweep: every (tile, flip) item a forward at batch 1
        mp_sweep = MultichipPredictor(single_stage, pf, mode="sweep", env=env)
        mp_sweep.warmup()
        ops.reset_launch_counts()
        g = mp_sweep.predict_arrays(images[0])
        items = len(tile_origins(canvas, exp.infer.tile, exp.infer.overlap)) * 8
        routes = _route_counts()
        want = _expected_routes([(fine_calls, -(-items // n) * n)])
        check(routes == want, f"sweep mode, {n} shards: routes {routes} "
                              f"(expected {want})")
        _tie_check(f"sweep mode, {n} shards, case 0", g, *refs["sweep"][0])
        # spatial: the whole canvas, split on X; logits vs the unsharded forward
        mp_sp = MultichipPredictor(raw, pf, mode="spatial", env=env)
        im = images[0]
        x = zscore(crop_cast_fit_np(im, brain_bbox_fast_np(im), canvas)
                   .to(dev).float())
        mp_sp._fwd(x)
        ops.reset_launch_counts()
        logits = mp_sp._fwd(x)
        routes = _route_counts()
        want = _expected_routes([(unet_calls(exp.unet, 1, canvas), n)], spatial=True)
        check(routes == want, f"spatial mode, {n} shards: routes {routes} "
                              f"(expected {want})")
        net = mp_sp.fine.on(dev)
        with torch.inference_mode():
            whole = net(x[None])[0]
        # the unsharded volume through the spatial route itself (one shard:
        # IN statistics from the statistics pass, not the conv's epilogue)
        one = make_spatial_unet(make_mesh([dev]), net)(x)
        for ref, what in ((one, "the one-shard spatial route"),
                          (whole, "the unsharded model's forward (IN "
                                  "statistics from the conv's epilogue)")):
            rel = ((logits - ref).abs().max() / ref.abs().max()).item()
            agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
            check(bool(torch.isfinite(logits).all()) and rel <= SPATIAL_TOL,
                  f"spatial mode, {n} shards: logits {tuple(logits.shape)} vs "
                  f"{what}, max|d|/max|ref| {rel:.3e} (tol {SPATIAL_TOL}), "
                  f"argmax agreement {agree:.6f}")
        # the same decomposition at f32 compute, where bf16 rounding no
        # longer hides a seam: vs the unsharded f32 forward
        with torch.inference_mode():
            whole = net32(x[None])[0]
        logits = make_spatial_unet(env, net32)(x)
        rel = ((logits - whole).abs().max() / whole.abs().max()).item()
        check(bool(torch.isfinite(logits).all()) and rel <= SPATIAL_F32_TOL,
              f"spatial mode at f32 compute, {n} shards: logits vs the "
              f"unsharded f32 forward, max|d|/max|ref| {rel:.3e} (tol "
              f"{SPATIAL_F32_TOL})")
        del whole, one, logits
        # device ms/vol of each mode's program on a prepared canvas
        c_img = crop_cast_fit_np(im, brain_bbox_fast_np(im), canvas).to(dev)
        for name, m in (("cascade", mp_raw), ("sweep", mp_sweep), ("spatial", mp_sp)):
            v = []
            for _ in range(3):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                m._run(c_img)
                ev[1].record()
                torch.cuda.synchronize()
                v.append(ev[0].elapsed_time(ev[1]))
            ms[(name, n)] = med(v)
        del mp, mp_raw, mp_sweep, mp_sp
        torch.cuda.empty_cache()
    print("  device ms/vol by mode (median of 3, CUDA events around the mesh "
          "program): " + ", ".join(f"{k[0]} x{k[1]} {v:.3f}" for k, v in ms.items())
          + f" on {card}", flush=True)
    return ms


def multichip_serve_burst(work, case_dirs, first, card):
    """9.3: one ``serve --multichip cascade`` burst over 2 shards of the
    card, Winograd conv backend."""
    from brats2019_tpu_torch import ops

    root = os.path.join(WORK, "mc_serve")
    watch, out = os.path.join(root, "watch"), os.path.join(root, "out")
    os.makedirs(watch)
    ops.set_backend("winograd")
    try:
        rc, s_vol, idle, counts, answers = burst(
            [watch, "--preset", PRESET, "--workdir", work, "--device",
             "cuda:0,cuda:0", "--multichip", "cascade", "--poll", "0.05",
             "--output-dir", out], case_dirs)
    finally:
        ops.set_backend("direct")
    check(rc == 0 and len(answers) == len(case_dirs)
          and all(a.get("error") is None for a in answers.values()),
          f"serve --multichip cascade over 2 shards: exit code {rc}, "
          f"{len(answers)} answers")
    check(counts["conv3d_winograd"] > 0 and counts["conv3d"] == 0
          and counts["conv3d_winograd.launches_wgmma"] == counts["conv3d_winograd"],
          f"serve --multichip cascade burst on the Winograd backend: "
          f"{counts['conv3d_winograd']} Winograd launches "
          f"({counts['conv3d_winograd.launches_wgmma']} on winograd3d_wgmma.cu), "
          f"{counts['conv3d']} direct")
    for d, ref in zip(case_dirs, first):
        seg = served_labels(out, [d])[0]
        agree = float((seg == ref).mean())
        check(agree >= MASK_AGREE,
              f"{os.path.basename(d)} served by the mesh daemon: agreement "
              f"with phase 3's direct-conv mask {agree:.6f} (bound {MASK_AGREE})")
    print(f"  serve --multichip cascade (2 shards, Winograd): burst of "
          f"{len(case_dirs)} {s_vol:.3f} s/vol, device idle {100 * idle:.1f}% "
          f"on {card}", flush=True)


def dp_slice(exp, dev, card):
    """9.4: the fine stage at full width, data-parallel over 2 shards of the
    card: the averaged grads of one step (f32 compute) against the mean of
    the one-shard grads of each shard's batch (DP_SHARD_TOL) and against the
    one-shard step on the concatenated batch (DP_GRAD_TOL), then a few bf16
    steps and their ms."""
    import copy
    import dataclasses

    import torch

    from brats2019_tpu_torch.parallel.mesh import make_mesh
    from brats2019_tpu_torch.train.loop import init_stage, stage_config
    from brats2019_tpu_torch.train.step import (TrainStep, make_microbatch_loss,
                                                sample_microbatch, shard_grads)

    ucfg, cfg, _ = stage_config(exp, "fine")
    env = make_mesh([dev] * 2)
    loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
    pools = [random_pool(cfg, dev) for _ in range(2)]
    # the grads, in f32
    model, opt = init_stage(dataclasses.replace(ucfg, compute_dtype="float32"),
                            cfg, dev)
    ref_model = copy.deepcopy(model)
    names = list(opt.params)
    step = TrainStep(model, cfg, loss_fn, opt, env=env)
    seen = []
    real = step.opt.step
    step.opt.step = lambda g: seen.append(
        torch.cat([g[k].reshape(-1) for k in names]).clone()) or real(g)
    aux = step(pools, 0)
    batches = [sample_microbatch(pools[j], cfg, 0, j) for j in range(2)]
    # each shard's batch through the one-shard path: their mean is what the
    # averaged step must apply
    per = [shard_grads(ref_model, loss_fn, [b], names)[0] for b in batches]
    mean = (per[0] + per[1]) / 2
    d_mean = float((seen[0] - mean).norm() / mean.norm())
    check(d_mean <= DP_SHARD_TOL,
          f"data-parallel step over 2 shards of the card (f32 compute): "
          f"averaged grads vs the mean of the one-shard grads of each shard's "
          f"batch, relative L2 {d_mean:.3e} (tol {DP_SHARD_TOL})")
    imgs, segs = zip(*batches)
    ref_model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(ref_model, torch.cat(imgs), torch.cat(segs))
    loss.backward()
    params = dict(ref_model.named_parameters())
    cat = torch.cat([params[k].grad.reshape(-1) for k in names])
    rel = float((seen[0] - cat).norm() / cat.norm())
    off, errs = 0, {}
    for k in names:
        n = params[k].numel()
        d, r = seen[0][off:off + n], cat[off:off + n]
        errs[k] = float((d - r).abs().max() / r.abs().max().clamp_min(1e-30))
        off += n
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(aux["loss"]) - loss.item()) / abs(loss.item())
    check(rel <= DP_GRAD_TOL and loss_rel <= 1e-5,
          f"data-parallel step over 2 shards of the card (f32 compute): "
          f"averaged grads vs the one-shard step on the concatenated batch, "
          f"relative L2 {rel:.3e} over all {len(params)} parameters "
          f"(tol {DP_GRAD_TOL}); per parameter worst {worst} max|d|/max|ref| "
          f"{errs[worst]:.3e}; loss {float(aux['loss']):.6f} vs {loss.item():.6f}")
    del model, opt, step, ref_model, seen
    torch.cuda.empty_cache()
    # a few steps at the stage's own bf16, and their time
    model, opt = init_stage(ucfg, cfg, dev)
    step = TrainStep(model, cfg, loss_fn, opt, env=env)
    losses = [float(step(pools, i)["loss"]) for i in range(3)]
    ms, aux = timed_steps(step, pools, warm=1, reps=5)
    losses.append(float(aux["loss"]))
    check(all(math.isfinite(v) for v in losses),
          f"data-parallel fine steps: losses {[round(v, 4) for v in losses]}")
    print(f"  data-parallel fine step, 2 shards of the card (batch 1 a shard, "
          f"patch {cfg.patch}): {ms:.3f} ms (CUDA events, mean of 5), "
          f"{2 * 1e3 / ms:.2f} patches/s on {card}", flush=True)
    del model, opt, step, pools
    torch.cuda.empty_cache()
    return ms


def spatial_train_slice(exp, dev, card):
    """9.4: ``make_spatial_train_grad`` on the fine net at full width, one
    SPATIAL_TRAIN_EDGE^3 volume split on X over 2 shards of the card. In f32:
    its loss and grads against the unsharded model's on the same volume
    (relative L2 within SPATIAL_GRAD_TOL), and in f32 and bf16: every conv,
    IN backward, up backward and down backward of every shard counted on the
    kernel its plan names (the IN backward on ``in_act_bwd.cu`` wherever the
    plan puts it there, in bf16 everywhere), finite grads."""
    import dataclasses

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.ops import _build, norm
    from brats2019_tpu_torch.parallel.mesh import make_mesh
    from brats2019_tpu_torch.parallel.spatial_unet import make_spatial_train_grad
    from brats2019_tpu_torch.train.loop import init_stage, stage_config

    ucfg, cfg, _ = stage_config(exp, "fine")
    n, v = 2, SPATIAL_TRAIN_EDGE
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((v, v, v, 4), generator=g, device=dev)
    y = torch.randint(0, 4, (v, v, v), generator=g, device=dev)
    calls = train_calls(ucfg, 1, (v // n, v, v))
    count = lambda name: sum(1 for c, _ in calls if c == name)
    in_shapes = [sh for c, sh in calls if c == "instance_norm_act_bwd"]
    sms = _build.sm_count(dev)
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        model, _ = init_stage(dataclasses.replace(ucfg, compute_dtype=dt), cfg, dev)
        fn = make_spatial_train_grad(make_mesh([dev] * n), model)
        ops.reset_launch_counts()
        loss, grads = fn(x, y)
        torch.cuda.synchronize()
        routes = {
            "conv3d": ops.conv3d.launches,
            "instance_norm_act_bwd": ops.instance_norm_act_bwd.launches,
            "instance_norm_act_bwd on in_act_bwd.cu":
                ops.instance_norm_act_bwd.launches_cuda,
            "upsample2x_bwd": ops.upsample2x_bwd.launches,
            "upsample2x_bwd on resize2x.cu": ops.upsample2x_bwd.launches_cuda,
            "downsample2x_bwd": ops.downsample2x_bwd.launches,
            "downsample2x_bwd on resize2x.cu": ops.downsample2x_bwd.launches_cuda}
        planned = sum(norm.plan_in_bwd(1, math.prod(sh[1:4]), sh[4], sms,
                                       dtype).route == "in_act_bwd.cu"
                      for sh in in_shapes)
        f32 = dtype == torch.float32
        want = {
            "conv3d": n * count("conv3d"),
            "instance_norm_act_bwd": n * len(in_shapes),
            "instance_norm_act_bwd on in_act_bwd.cu": n * planned,
            "upsample2x_bwd": n * count("upsample2x_bwd"),
            "upsample2x_bwd on resize2x.cu": n * count("upsample2x_bwd"),
            "downsample2x_bwd": n * count("downsample2x_bwd"),
            # the bf16 down backward is the Triton kernel (row 5)
            "downsample2x_bwd on resize2x.cu": n * count("downsample2x_bwd") if f32 else 0}
        finite = all(bool(torch.isfinite(t).all()) for t in grads.values())
        check(routes == want and finite and (f32 or planned == len(in_shapes)),
              f"spatial training grads, {n} shards of the card, {dt}: launches "
              f"{routes} (expected {want}; {planned} of {len(in_shapes)} IN "
              f"backwards a shard planned on in_act_bwd.cu), grads finite {finite}")
        # the unsharded model's grads of the same loss on the whole volume
        spatial = {k: t.clone() for k, t in grads.items()}
        model.zero_grad(set_to_none=True)
        logp = torch.log_softmax(model(x[None]).float(), dim=-1)
        whole_loss = -logp.gather(-1, y[None].long().unsqueeze(-1)).mean()
        whole_loss.backward()
        whole = {k: p.grad for k, p in model.named_parameters()}
        rel = math.sqrt(sum(float((spatial[k] - whole[k]).float().square().sum())
                            for k in whole)
                        / sum(float(whole[k].float().square().sum()) for k in whole))
        loss_rel = abs(float(loss) - whole_loss.item()) / abs(whole_loss.item())
        if f32:
            check(rel <= SPATIAL_GRAD_TOL and loss_rel <= 1e-5,
                  f"spatial training grads, {n} shards of the card, f32: vs the "
                  f"unsharded model's on the same {v}^3 volume, relative L2 "
                  f"{rel:.3e} over all {len(whole)} parameters (tol "
                  f"{SPATIAL_GRAD_TOL}); loss {float(loss):.6f} vs "
                  f"{whole_loss.item():.6f}")
        else:
            print(f"  spatial training grads, bf16: vs the unsharded model's, "
                  f"relative L2 {rel:.3e}; loss {float(loss):.6f} vs "
                  f"{whole_loss.item():.6f} on {card}", flush=True)
        del model, fn, grads, spatial, whole
        torch.cuda.empty_cache()


def multiprocess_slice(card):
    """9.5: the launcher: one process over NCCL; two processes sharing the
    card over gloo against one process of two shards."""
    import torch

    from brats2019_tpu_torch.data import synthetic
    from brats2019_tpu_torch.parallel.mesh import make_mesh
    from brats2019_tpu_torch.parallel.multiprocess import (decode_mask,
                                                           flagship_workload,
                                                           launch_workers)

    root = os.path.join(WORK, "mp")
    data = os.path.join(root, "data")
    synthetic.write_dataset(data, 2, shape=(64, 40, 36), seed0=SEED)
    t0 = time.perf_counter()
    one = flagship_workload(data, os.path.join(root, "one"),
                            env=make_mesh(["cuda:0"] * 2))
    t1 = time.perf_counter()
    nccl = launch_workers(data, os.path.join(root, "nccl"), num_processes=1,
                          shards_per_process=1, device="cuda", backend="nccl",
                          timeout=600)[0]
    t2 = time.perf_counter()
    check(nccl["backend"] == "nccl" and nccl["bringup_sum"] == 1.0
          and nccl["forbidden_modules"] == []
          and math.isfinite(nccl["loss_first"]) and math.isfinite(nccl["loss_resumed"]),
          f"one worker over NCCL: bring-up all-reduce {nccl['bringup_sum']}, "
          f"losses {nccl['loss_first']:.5f} / {nccl['loss_resumed']:.5f}, "
          f"forbidden modules {nccl['forbidden_modules']} ({t2 - t1:.1f} s)")
    two = launch_workers(data, os.path.join(root, "two"), num_processes=2,
                         shards_per_process=1, device="cuda", backend="gloo",
                         cuda_visible=["0", "0"], timeout=600)
    t3 = time.perf_counter()
    for r in two:
        close = all(abs(r[k] - one[k]) <= MP_LOSS_RTOL * abs(one[k])
                    for k in ("loss_first", "loss_resumed"))
        same = bool((decode_mask(r) == decode_mask(one)).all())
        check(r["backend"] == "gloo" and r["bringup_sum"] == 3.0 and close
              and same and r["forbidden_modules"] == [],
              f"two workers on the card over gloo: losses {r['loss_first']:.6f} "
              f"/ {r['loss_resumed']:.6f} vs one process of two shards "
              f"{one['loss_first']:.6f} / {one['loss_resumed']:.6f} (rtol "
              f"{MP_LOSS_RTOL}); cascade mask equal {same}")
    print(f"  multi-process: one process x 2 shards {t1 - t0:.1f} s, 1 NCCL "
          f"worker {t2 - t1:.1f} s, 2 gloo workers {t3 - t2:.1f} s (with "
          f"start-up) on {card}", flush=True)
    torch.cuda.empty_cache()


def phase9(exp, work, case_dirs, first, dev, card):
    """Phase 9: the native decoder, the params export, the mesh modes, data
    parallelism and the multi-process launcher (module docstring)."""
    import torch

    t0 = time.perf_counter()
    decoder = decoder_slice(exp, work, case_dirs, card)
    print(f"  9.1 (decoder) took {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    export_slice(os.path.join(WORK, "cases"), card)
    print(f"  9.2 (export) took {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    check_shard_statistics(exp, dev)
    mesh_modes(exp, work, case_dirs, first, dev, card)
    multichip_serve_burst(work, case_dirs, first, card)
    torch.cuda.empty_cache()
    print(f"  9.3 (mesh modes) took {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    spatial_train_slice(exp, dev, card)
    dp_slice(exp, dev, card)
    print(f"  9.4 (spatial grads, data parallel) took "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    multiprocess_slice(card)
    print(f"  9.5 (multi-process) took {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    return decoder



# ----------------------------------------------------------------- phase 10 --

PAIR_TURNS = 2   # (singles, pair, pair, singles) rounds timed in 10.1
BURST_CASES = 8   # a burst of 10.1-10.2: one serve chunk, 4 pairs
BURST_TURNS = 3   # rounds of the three burst arms, in turns
RSS_LIMIT_MB = 100   # below any CUDA daemon's resident set after start-up
# the int8 transfer's masks against the bf16 path's: the JAX package's own
# bar (tests/test_inference.py:227)
INT8_AGREE = 0.98


def check_b16_top(exp, dev):
    """10.1: rows 1, 2 and 6 at the fine net's top level at batch 16, the
    pair program's largest tensors (the concat buffer 16 x 64^3 x 192,
    805,306,368 elements): each conv on the wgmma instance with the STATS epilogue
    against the plain conv (max|d|/max|ref| <= 1e-2), its IN+act from the
    partials against the plain IN+act (2 bf16 ulp), the up into the concat
    against the plain up (1 bf16 ulp) with the skip half bitwise."""
    import torch

    from brats2019_tpu_torch.ops import conv, norm, resize

    calls = unet_calls(exp.unet, 16, exp.infer.roi_shape)
    top = tuple(v // exp.unet.stem_downsample for v in exp.infer.roi_shape)
    g = torch.Generator(device=dev).manual_seed(16)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max()).item()
    for shape in dict.fromkeys(sh for sh in conv_norm_shapes(calls)
                               if sh[1:4] == top):
        n, d, h, w, ci, co = shape
        x = torch.randn((n, d, h, w, ci), generator=g, device=dev).bfloat16()
        wt = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev)
              / (27 * ci) ** 0.5).bfloat16()
        gam = torch.rand(co, generator=g, device=dev) + 0.5
        bet = torch.randn(co, generator=g, device=dev) * 0.2
        plan = conv.plan_conv(*shape)
        before = (conv.conv3d.launches_wgmma, conv.conv3d.launches_stats)
        y, part = conv.conv3d_kernel(x, wt, stats=True)
        took = (conv.conv3d.launches_wgmma - before[0],
                conv.conv3d.launches_stats - before[1])
        err = rel(y, conv.conv3d_plain(x, wt))
        u = bf16_ulps(norm.instance_norm_act_kernel(y, gam, bet, partials=part)[0],
                      norm.instance_norm_act_plain(y, gam, bet))
        check(plan.instance == "wgmma" and took == (1, 1) and err <= 1e-2
              and u <= 2,
              f"batch 16, top level: conv {shape} ({x.numel()} input "
              f"elements) on {plan.instance} with the STATS epilogue {took}, "
              f"max|d|/max|ref| {err:.3e} (tol 1e-2); IN+act from its partials "
              f"{u:.2f} bf16 ulp (tol 2)")
        del x, y, part
        torch.cuda.empty_cache()
    for shape, cs in dict.fromkeys(sc for sc in up_concats(calls)
                                   if tuple(2 * v for v in sc[0][1:4]) == top):
        n, d, h, w, c = shape
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g,
                           device=dev).bfloat16()
        before = resize.upsample2x.launches_concat
        got = resize.upsample2x_concat_kernel(x, skip)
        into = resize.upsample2x.launches_concat - before
        u = bf16_ulps(got[..., :c], resize.upsample2x_plain(x))
        same = bool(torch.equal(got[..., c:], skip))
        check(u <= 1 and same and into == 1,
              f"batch 16, top level: up {shape} into the concat "
              f"{tuple(got.shape)} ({got.numel()} elements): {u:.2f} bf16 ulp "
              f"(tol 1), skip half bitwise {same}, {into} launch into the buffer")
        del x, skip, got
        torch.cuda.empty_cache()


def pairing_slice(exp, work, case_dirs, first, dev, card):
    """10.1: volume pairing (``batch_volumes=2``) on the flagship cascade at
    full width (module docstring)."""
    import dataclasses

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.data.constants import disk_to_internal
    from brats2019_tpu_torch.infer.predictor import Predictor

    pf = os.path.join(work, "fine", "params.npz")
    pc = os.path.join(work, "coarse", "params.npz")
    with_infer = lambda e, **kw: dataclasses.replace(
        e, infer=dataclasses.replace(e.infer, **kw))
    raw = with_infer(exp, min_component_voxels=0, et_min_voxels=0, postproc="host")
    images = [load_case(d).image for d in case_dirs]
    single = Predictor(raw, pf, pc, device=dev)
    paired = Predictor(with_infer(raw, batch_volumes=2), pf, pc, device=dev)
    paired.warmup()
    for i, (got, im) in enumerate(zip(paired.predict_arrays_many(images), images)):
        _tie_check(f"paired labels (postprocessing off), case {i} of "
                   f"{len(images)} (one pair and an odd tail)", got,
                   single.predict_arrays(im)[0], single.predict_probs_arrays(im)[0])
    post = Predictor(with_infer(exp, batch_volumes=2), pf, pc, device=dev)
    for i, (got, seg) in enumerate(zip(post.predict_arrays_many(images), first)):
        agree = float((got == disk_to_internal(seg)).mean())
        check(agree >= MESH_MASK_AGREE,
              f"paired and postprocessed, case {i}: agreement with phase 3's "
              f"mask {agree:.7f} (bound {MESH_MASK_AGREE})")
    # the pair program's routes: two stage_roi, one fine forward at batch 16
    ops.reset_launch_counts()
    paired.predict_arrays_many(images[:2])
    coarse = unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
    fine16 = unet_calls(exp.unet, 16, exp.infer.roi_shape)
    want = {k: 2 * sum(1 for n, _ in coarse if n == k)
            + sum(1 for n, _ in fine16 if n == k) for k in FORWARD}
    routes = {"conv3d on conv3d_wgmma.cu": ops.conv3d.launches_wgmma,
              "conv3d with the statistics epilogue": ops.conv3d.launches_stats,
              "instance_norm_act from partials": ops.instance_norm_act.launches_partials,
              "upsample2x on resize2x.cu": ops.upsample2x.launches_cuda,
              "upsample2x into the concat": ops.upsample2x.launches_concat}
    want_routes = {"conv3d on conv3d_wgmma.cu": want["conv3d"],
                   "conv3d with the statistics epilogue": want["conv3d"],
                   "instance_norm_act from partials": want["instance_norm_act"],
                   "upsample2x on resize2x.cu": want["upsample2x"],
                   "upsample2x into the concat": want["upsample2x"]}
    got = {k: getattr(ops, k).launches for k in FORWARD}
    check(got == want and routes == want_routes,
          f"one pair (two stage_roi, one fine forward at batch 16): launches "
          f"{got} (expected {want}); routes {routes} (expected {want_routes})")
    check_b16_top(exp, dev)
    # device ms/vol: one pair against two single volumes, in turns; the
    # fine stage (one stage_finish_pair, or two stage_finish) also alone
    prog = single.program
    canv = [single.prepare(im)[0] for im in images[:2]]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def run(paired_run):
        ev[0].record()
        (ta, sa), (tb, sb) = (prog.stage_roi(c) for c in canv)
        ev[1].record()
        if paired_run:
            prog.stage_finish_pair(ta, tb, sa, sb)
        else:
            prog.stage_finish(ta, sa)
            prog.stage_finish(tb, sb)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[2]) / 2, ev[1].elapsed_time(ev[2]) / 2

    ms = {"singles": [], "pair": [], "singles fine": [], "pair fine": []}
    with torch.inference_mode():
        run(True)
        for _ in range(PAIR_TURNS):
            for name in ("singles", "pair", "pair", "singles"):
                whole, fine = run(name == "pair")
                ms[name].append(whole)
                ms[name + " fine"].append(fine)
    med = lambda v: sorted(v)[len(v) // 2]
    print("  device ms/vol, in turns (CUDA events, 2 volumes a run): " + "; ".join(
        f"{k} {med(v):.3f} (all {[round(x, 3) for x in v]})"
        for k, v in ms.items()) + f" on {card}", flush=True)
    del single, paired, post, canv
    torch.cuda.empty_cache()
    return {k: med(v) for k, v in ms.items()}


def burst_cases(case_dirs, n):
    """``n`` case directories under new names (hard links to the phase-3
    cases' modality files, taken round robin), so a burst holds ``n``
    distinct cases."""
    from brats2019_tpu_torch.data.case import modality_paths

    out = []
    for k in range(n):
        src = case_dirs[k % len(case_dirs)]
        base, name = os.path.basename(src), f"BraTS19_BURST_{k:03d}_1"
        dst = os.path.join(WORK, "burst_cases", name)
        os.makedirs(dst)
        for p in modality_paths(src):
            q = os.path.join(dst, os.path.basename(p).replace(base, name, 1))
            try:
                os.link(p, q)
            except OSError:
                shutil.copyfile(p, q)
        out.append(dst)
    return out


def leftout_bursts(exp, work, case_dirs, first, card):
    """10.1 and 10.2: ``serve`` bursts of BURST_CASES cases (one serve chunk:
    BURST_CASES // 2 pairs with ``--batch-volumes 2``) on the Winograd
    backend (device postprocessing, a fresh payload cache each): ``--batch-
    volumes 1`` (bf16), ``--batch-volumes 2``, ``--transfer-dtype int8``,
    BURST_TURNS rounds in turns; each arm's s/vol and device idle share
    (the CUDA-event edges of the program's ``predict.program`` spans),
    median and spread, and the volumes each burst ran in a pair (from its Winograd
    launches)."""
    from brats2019_tpu_torch import ops

    cases = burst_cases(case_dirs, BURST_CASES)
    refs = [first[k % len(first)] for k in range(len(cases))]
    convs = lambda cfg, shape: sum(1 for k, _ in unet_calls(cfg, 8, shape)
                                   if k == "conv3d")
    fine = convs(exp.unet, exp.infer.roi_shape)
    single = fine + convs(exp.coarse_unet, exp.infer.coarse_shape)
    root = os.path.join(WORK, "leftout_bursts")
    arms = (("bf16", []), ("pair", ["--batch-volumes", "2"]),
            ("int8", ["--transfer-dtype", "int8"]))
    runs = {name: [] for name, _ in arms}
    for turn in range(BURST_TURNS):
        for name, flags in (arms if turn % 2 == 0 else arms[::-1]):
            tag = f"{name}_{turn}"
            watch, served = (os.path.join(root, f"{d}_{tag}") for d in ("watch", "out"))
            os.makedirs(watch)
            ops.set_backend("winograd")
            try:
                rc, s_vol, idle, counts, answers = burst(
                    [watch, "--preset", PRESET, "--workdir", work, "--device",
                     DEVICE, "--poll", "0.05", "--output-dir", served,
                     "--prep-cache", os.path.join(root, f"cache_{tag}"),
                     "--postproc", "device", *flags], cases, one_scan=True)
            finally:
                ops.set_backend("direct")
            sizes, batches = [r["batch_size"] for r in serve_log(served)], []
            while sum(batches) < len(sizes):   # one record a case, by batch
                batches.append(sizes[sum(batches)])
            agree = [float((a == b).mean())
                     for a, b in zip(served_labels(served, cases), refs)]
            wino = counts["conv3d_winograd"]
            paired = 2 * (len(cases) * single - wino) // fine
            check(rc == 0 and len(answers) == len(cases) and batches == [len(cases)]
                  and all(a.get("error") is None for a in answers.values())
                  and wino > 0 and counts["conv3d"] == 0
                  and counts["conv3d_winograd.launches_wgmma"] == wino
                  and min(agree) >= (INT8_AGREE if name == "int8" else MASK_AGREE),
                  f"serve burst {turn + 1} of {BURST_TURNS}, "
                  f"{' '.join(flags) or '(bf16, one volume a program)'}: exit "
                  f"code {rc}, {len(answers)} answers, batches "
                  f"{batches}; {wino} Winograd launches "
                  f"({counts['conv3d_winograd.launches_wgmma']} on "
                  f"winograd3d_wgmma.cu), {counts['conv3d']} direct, {paired} of "
                  f"{len(cases)} volumes in a pair; agreement with phase 3's "
                  f"masks >= {min(agree):.6f}; {s_vol:.3f} s/vol, device idle "
                  f"{100 * idle:.1f}%")
            runs[name].append((s_vol, idle, paired))
    med = lambda v: sorted(v)[len(v) // 2]
    out = {}
    for name, got in runs.items():
        sv, idle, paired = ([g[i] for g in got] for i in range(3))
        out[name] = (med(sv), med(idle))
        print(f"  serve bursts of {len(cases)}, {name}, {len(got)} in turns "
              f"(Winograd, device postprocessing, fresh cache): s/vol median "
              f"{med(sv):.3f}, spread {min(sv):.3f}-{max(sv):.3f} (all "
              f"{[round(v, 3) for v in sv]}); device idle median "
              f"{100 * med(idle):.1f}%, spread {100 * min(idle):.1f}-"
              f"{100 * max(idle):.1f}%; volumes in a pair {paired} on {card}",
              flush=True)
    return out


def int8_slice(exp, work, case_dirs, first, card):
    """10.2: the int8 transfer on the phase-3 cases: masks against phase
    3's bf16 masks, the payload's host-to-device bytes of both encodings, a
    payload-cache hit against a miss, one-by-one e2e in turns."""
    import dataclasses

    import numpy as np

    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer import predictor as pmod
    from brats2019_tpu_torch.utils.nifti import read_nifti

    pf = os.path.join(work, "fine", "params.npz")
    pc = os.path.join(work, "coarse", "params.npz")
    root = os.path.join(WORK, "int8")
    cache = os.path.join(root, "cache")
    make = lambda **kw: pmod.Predictor(dataclasses.replace(
        exp, infer=dataclasses.replace(exp.infer, **kw)), pf, pc, device=DEVICE)
    preds = {"bfloat16": make(), "int8": make(transfer_dtype="int8")}
    cached8 = make(transfer_dtype="int8", prep_cache_dir=cache)
    sent = {"bfloat16": [], "int8": []}
    real = pmod.Predictor._payload_to_device

    def counted(self, small, dst, lane=0):
        sent[self.exp.infer.transfer_dtype].append(small.numel() * small.element_size())
        return real(self, small, dst, lane)

    outs = {k: [os.path.join(root, f"{k}_{i}.nii.gz") for i in range(len(case_dirs))]
            for k in ("bfloat16", "int8", "miss", "hit")}
    os.makedirs(root, exist_ok=True)
    pmod.Predictor._payload_to_device = counted
    try:
        preds["bfloat16"].predict_dirs(case_dirs, outs["bfloat16"])
        preds["int8"].predict_dirs(case_dirs, outs["int8"])
    finally:
        pmod.Predictor._payload_to_device = real
    # the copy alone, as the transfer advisory reads it (CUDA events)
    copy_ms = {k: [1e3 * t for t in p._copy_seconds(len(case_dirs))]
               for k, p in preds.items()}
    check(sum(sent["int8"]) * 2 == sum(sent["bfloat16"]) > 0,
          f"host-to-device payload bytes over {len(case_dirs)} cases: bf16 "
          f"{sent['bfloat16']}, int8 {sent['int8']} (int8 half of bf16); the "
          f"copy's device ms a case: bf16 "
          f"{[round(v, 3) for v in copy_ms['bfloat16']]}, int8 "
          f"{[round(v, 3) for v in copy_ms['int8']]} on {card}")
    read = lambda p: read_nifti(p, apply_scaling=False)[0]
    for i, (p8, p16, ref) in enumerate(zip(outs["int8"], outs["bfloat16"], first)):
        a8, a16 = float((read(p8) == ref).mean()), float((read(p16) == ref).mean())
        check(a8 > INT8_AGREE and a16 >= MASK_AGREE,
              f"case {i}: int8 transfer's mask against phase 3's bf16 mask "
              f"{a8:.6f} (bound > {INT8_AGREE}); this bf16 predictor's "
              f"{a16:.6f}")
    cached8.predict_dirs(case_dirs, outs["miss"])        # stores the entries
    real_load = pmod.load_case

    def no_decode(*a, **k):
        raise AssertionError("decoded on a payload-cache hit")

    pmod.load_case = no_decode
    try:
        cached8.predict_dirs(case_dirs, outs["hit"])
    finally:
        pmod.load_case = real_load
    same = [bool(np.array_equal(read(a), read(b)))
            for a, b in zip(outs["hit"], outs["miss"])]
    check(all(same) and len(os.listdir(cache)) == len(case_dirs),
          f"int8 payload-cache hits (no decode) give the misses' masks {same}; "
          f"{len(os.listdir(cache))} int8 entries")
    del cached8
    # the host side of each encoding: the crop (and cast or quantize) alone
    images = [load_case(d) for d in case_dirs]
    enc = {dt: [] for dt in preds}
    for dt in ("bfloat16", "int8", "int8", "bfloat16"):
        for c in images:
            t0 = time.perf_counter()
            preds[dt]._encode_host(c.image, c.meta)
            enc[dt].append(time.perf_counter() - t0)
    del images
    e2e = {"bfloat16": [], "int8": []}
    tmp = os.path.join(root, "timed.nii.gz")
    for dt in ("bfloat16", "int8", "int8", "bfloat16"):
        for d in case_dirs:
            t0 = time.perf_counter()
            preds[dt].predict_dir(d, tmp)
            e2e[dt].append(time.perf_counter() - t0)
    med = lambda v: sorted(v)[len(v) // 2]
    print(f"  e2e s/vol one by one, in turns: bf16 {med(e2e['bfloat16']):.3f} "
          f"(all {[round(v, 3) for v in e2e['bfloat16']]}); int8 "
          f"{med(e2e['int8']):.3f} (all {[round(v, 3) for v in e2e['int8']]}); "
          f"host encode s/vol (bbox, crop and cast or quantize), in turns: bf16 "
          f"{med(enc['bfloat16']):.3f}, int8 {med(enc['int8']):.3f} on {card}",
          flush=True)
    return {k: med(v) for k, v in e2e.items()}


def recycle_slice(work, case_dirs, card):
    """10.3: ``serve --supervise --rss-limit-mb RSS_LIMIT_MB`` as a process on
    the card, a burst of the phase-3 cases dropped into its watch root: every
    case answered once in the completion log, at least one exit-4 recycle,
    then SIGTERM stops the supervisor with exit code 0."""
    root = os.path.join(WORK, "recycle")
    watch, served = os.path.join(root, "watch"), os.path.join(root, "out")
    os.makedirs(watch)
    log_path = os.path.join(root, "supervisor.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "brats2019_tpu_torch.cli.serve", watch,
             "--preset", PRESET, "--workdir", work, "--device", DEVICE,
             "--output-dir", served, "--poll", "0.1", "--supervise",
             "--rss-limit-mb", str(RSS_LIMIT_MB)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            for d in case_dirs:
                shutil.copytree(d, os.path.join(watch, os.path.basename(d)),
                                ignore=shutil.ignore_patterns("*_pred.nii.gz"))
            deadline = time.time() + 240
            recs, text = [], ""
            while time.time() < deadline and proc.poll() is None:
                time.sleep(0.5)
                with open(log_path) as f:
                    text = f.read()
                recs = (serve_log(served) if os.path.exists(
                    os.path.join(served, "serve_log.jsonl")) else [])
                if len(recs) >= len(case_dirs) and "supervise: daemon recycled" in text:
                    break
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        text = f.read()
    recs = serve_log(served)
    names = sorted(r["case"] for r in recs if r.get("error") is None)
    recycles = text.count("exiting for a supervisor restart")
    check(rc == 0 and names == sorted(os.path.basename(d) for d in case_dirs)
          and len(recs) == len(case_dirs) and recycles >= 1
          and "supervise: daemon recycled" in text,
          f"serve --supervise --rss-limit-mb {RSS_LIMIT_MB}: supervisor exit code "
          f"{rc} after SIGTERM; completion log {len(recs)} records for "
          f"{len(case_dirs)} cases, each once: {names}; {recycles} exit-4 "
          f"recycle(s) ({time.perf_counter() - t0:.1f} s)")
    if rc != 0 or recycles < 1:
        print(text[-4000:], flush=True)


def kd_mixed_mesh(card):
    """10.4: a KD step of ``unit`` (f32) with 2 teachers over the mesh
    ``cuda:0, cpu``: each shard's teachers on its device, losses and grads
    within DP_GRAD_TOL of the same step over ``cpu, cpu``, the card shard's
    IN, up and down backwards counted on their kernels; then ``train_stage``
    with the teachers over that mesh for 2 steps."""
    import dataclasses
    import types

    import numpy as np
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.case import discover_cases
    from brats2019_tpu_torch.parallel.mesh import make_mesh
    from brats2019_tpu_torch.train.distill import (KDConfig, build_teachers,
                                                   make_kd_microbatch_loss,
                                                   teacher_replicas)
    from brats2019_tpu_torch.train.loop import init_stage, stage_config, train_stage
    from brats2019_tpu_torch.train.step import TrainStep
    from brats2019_tpu_torch.utils.weights import init_params

    exp = get_preset("unit")
    ucfg, cfg, _ = stage_config(exp, "fine")
    tparams = [init_params(ucfg, s) for s in (7, 8)]
    rng = np.random.default_rng(10)
    patch = tuple(cfg.patch)
    data = [(rng.normal(size=(1,) + patch + (4,)).astype(np.float32),
             rng.integers(0, 4, size=(1,) + patch).astype(np.uint8))
            for _ in range(2)]
    runs = {}
    for name, devs in (("mixed", ["cuda:0", "cpu"]), ("cpu", ["cpu", "cpu"])):
        env = make_mesh(devs)
        model, opt = init_stage(ucfg, cfg, env.first)
        teachers = build_teachers(ucfg, tparams, env.first)
        reps = teacher_replicas(teachers, env.local_devices())
        placed = all(next(t.parameters()).device == dev
                     for dev, ts in reps.items() for t in ts)
        step = TrainStep(model, cfg, make_kd_microbatch_loss(reps, cfg, KDConfig()),
                         opt, env=env)
        pools = [types.SimpleNamespace(
            image=torch.from_numpy(img).to(dev), seg=torch.from_numpy(seg).to(dev),
            fg_host=np.zeros((1, 16, 3), np.int32))
            for dev, (img, seg) in zip(env.devices, data)]
        seen = []
        real = step.opt.step
        names = list(step.opt.params)
        step.opt.step = lambda g: seen.append(torch.cat(
            [g[k].reshape(-1) for k in names]).cpu()) or real(g)
        ops.reset_launch_counts()
        aux = step(pools, 0)
        counts = {k: (getattr(ops, k).launches, getattr(ops, k).launches_cuda)
                  for k in BACKWARD}
        runs[name] = (seen[0], {k: float(v) for k, v in aux.items()}, counts,
                      placed, [str(d) for d in reps])
    (g_mix, aux_mix, counts, placed, devs), (g_cpu, aux_cpu, _, _, _) = (
        runs["mixed"], runs["cpu"])
    d_grad = float((g_mix - g_cpu).norm() / g_cpu.norm())
    d_loss = max(abs(aux_mix[k] - aux_cpu[k]) / abs(aux_cpu[k])
                 for k in ("loss", "kd_loss"))
    check(placed and devs == ["cuda:0", "cpu"],
          f"KD over cuda:0, cpu: teacher replicas on {devs}, each shard's on its "
          f"device: {placed}")
    check(d_grad <= DP_GRAD_TOL and d_loss <= DP_GRAD_TOL,
          f"KD step over cuda:0, cpu (unit, f32, 2 teachers) against cpu, cpu: "
          f"grads relative L2 {d_grad:.3e}, loss/kd_loss {d_loss:.3e} (tol "
          f"{DP_GRAD_TOL}); loss {aux_mix['loss']:.6f} vs {aux_cpu['loss']:.6f}")
    calls = train_calls(ucfg, cfg.batch_per_device, patch)
    k = max(cfg.grad_accum_steps, 1)
    n_of = lambda name: k * sum(1 for c, _ in calls if c == name)
    cuda_in, all_in = f32_bwd_cuda_share("unit")
    want = {"instance_norm_act_bwd": (n_of("instance_norm_act_bwd"), k * cuda_in),
            "upsample2x_bwd": (n_of("upsample2x_bwd"),) * 2,
            "downsample2x_bwd": (n_of("downsample2x_bwd"),) * 2}
    check(counts == want and k * all_in == want["instance_norm_act_bwd"][0],
          f"the card shard's backwards (launches, on in_act_bwd.cu / "
          f"resize2x.cu): {counts} (expected {want})")
    # the loop's path: train_stage builds the replicas itself
    t0 = time.perf_counter()
    mixed = make_mesh(["cuda:0", "cpu"])
    e = dataclasses.replace(exp, workdir=os.path.join(WORK, "kd_mixed"),
                            train=dataclasses.replace(exp.train, steps=2,
                                                      pool_refresh_every=0))
    train_stage(e, discover_cases(os.path.join(WORK, "cases")), stage="fine",
                kd_teachers=build_teachers(ucfg, tparams, mixed.first), env=mixed)
    with open(os.path.join(e.workdir, "fine", "fine_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if '"kd_loss"' in line]
    check(len(recs) == 2 and all(math.isfinite(r["loss"]) and r["kd_loss"] > 0
                                 for r in recs),
          f"train_stage with 2 teachers over cuda:0, cpu: {len(recs)} KD steps "
          f"logged, losses {[round(r['loss'], 5) for r in recs]} "
          f"({time.perf_counter() - t0:.1f} s)")


def phase10(exp, work, case_dirs, first, dev, card):
    """Phase 10: volume pairing, the int8 transfer, the RSS recycle and KD
    over two distinct local devices (module docstring)."""
    import torch

    t0 = time.perf_counter()
    pairing_slice(exp, work, case_dirs, first, dev, card)
    print(f"  10.1 (pairing) took {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    int8_slice(exp, work, case_dirs, first, card)
    leftout_bursts(exp, work, case_dirs, first, card)
    torch.cuda.empty_cache()
    print(f"  10.2 (int8; the bursts of 10.1 and 10.2) took "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    recycle_slice(work, case_dirs, card)
    print(f"  10.3 (RSS recycle) took {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    kd_mixed_mesh(card)
    print(f"  10.4 (KD over cuda:0, cpu) took {time.perf_counter() - t1:.1f} s",
          flush=True)
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)


# ----------------------------------------------------------------- phase 11 --

EXPORT_TURNS = 2   # (eager, exported, exported, eager) rounds timed in phase 11


def _export_routes():
    """The forward kernels' route counters that an exported program must
    reproduce, launch for launch."""
    from brats2019_tpu_torch import ops

    return {
        "conv3d": ops.conv3d.launches,
        "conv3d on conv3d_wgmma.cu": ops.conv3d.launches_wgmma,
        "conv3d with the statistics epilogue": ops.conv3d.launches_stats,
        "conv3d_winograd": ops.conv3d_winograd.launches,
        "conv3d_winograd on winograd3d_wgmma.cu": ops.conv3d_winograd.launches_wgmma,
        "instance_norm_act": ops.instance_norm_act.launches,
        "instance_norm_act from partials": ops.instance_norm_act.launches_partials,
        "upsample2x": ops.upsample2x.launches,
        "upsample2x into the concat": ops.upsample2x.launches_concat,
        "downsample2x": ops.downsample2x.launches,
        "label_components": ops.label_components.launches,
    }


def _program_inputs(ep):
    """(kinds of the program's non-user inputs, its op nodes by target)."""
    kinds = sorted({s.kind.name for s in ep.graph_signature.input_specs
                    if s.kind.name != "USER_INPUT"})
    nodes = {}
    for n in ep.graph.nodes:
        if n.op == "call_function":
            nodes[str(n.target)] = nodes.get(str(n.target), 0) + 1
    return kinds, nodes


def exported_against_eager(what, pred, out_dir, canvases, calls, card,
                           winograd=False):
    """One exported program against the eager one on the card: each
    canvas's labels and start bitwise (``run_exported`` on the first, the
    program loaded once on the rest), one volume's launches by route equal to
    the eager volume's and to what the program's nets give, no parameter or
    buffer input in any ``.pt2``, and device ms/vol of both in turns.
    Returns (eager, exported) medians."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.infer import export_hlo

    man = json.load(open(os.path.join(out_dir, "manifest.json")))
    for mod, entry in man["modules"].items():
        ep = torch.export.load(os.path.join(out_dir, entry["file"]))
        kinds, nodes = _program_inputs(ep)
        mine = {k: v for k, v in nodes.items() if k.startswith("brats_torch.")}
        check(not set(kinds) & {"PARAMETER", "BUFFER"}
              and not any("convolution" in k for k in nodes),
              f"{what}: {entry['file']} ({entry['bytes']} bytes, "
              f"{len(entry['inputs_flat'])} inputs) holds no parameter or "
              f"buffer input (other inputs: {kinds}) and no aten convolution; "
              f"its kernel nodes {mine}")
    pf = export_hlo.flat_params(pred.fine)
    pc = None if pred.coarse is None else export_hlo.flat_params(pred.coarse)
    run = export_hlo.load_exported(out_dir)
    expect = {k: sum(1 for n, _ in calls if n == k)
              for k in ("conv3d", "instance_norm_act", "upsample2x",
                        "downsample2x")}
    conv = "conv3d_winograd" if winograd else "conv3d"
    want = dict.fromkeys(_export_routes(), 0)
    want.update({conv: expect["conv3d"],
                 f"{conv} on {'winograd3d' if winograd else 'conv3d'}_wgmma.cu":
                     expect["conv3d"],
                 "instance_norm_act": expect["instance_norm_act"],
                 "upsample2x": expect["upsample2x"],
                 "upsample2x into the concat": expect["upsample2x"],
                 "downsample2x": expect["downsample2x"]})
    inf = pred.exp.infer   # the device postprocessing labels once a volume
    want["label_components"] = int(inf.postproc == "device"
                                   and inf.min_component_voxels > 1)
    if not winograd:   # the direct conv's epilogue feeds every IN
        want["conv3d with the statistics epilogue"] = expect["conv3d"]
        want["instance_norm_act from partials"] = expect["instance_norm_act"]
    for i, canvas in enumerate(canvases):
        ops.reset_launch_counts()
        live = pred.predict_device(canvas)
        torch.cuda.synchronize()
        eager_routes = _export_routes()
        ops.reset_launch_counts()
        got = (export_hlo.run_exported(out_dir, pf, pc, canvas) if i == 0
               else run(pf, pc, canvas))
        torch.cuda.synchronize()
        exported_routes = _export_routes()
        same = all(a.dtype == b.dtype and a.shape == b.shape
                   and bool(torch.equal(a, b)) for a, b in zip(live, got))
        check(same, f"{what}, case {i}: the exported program's labels "
                    f"{tuple(got[0].shape)} and start {got[1].tolist()} "
                    f"bitwise the eager program's")
        if i == 0:
            print(f"  {what}: launches of one volume by route, eager "
                  f"{eager_routes}, exported {exported_routes}", flush=True)
            check(exported_routes == eager_routes == want,
                  f"{what}: one exported volume's launches by route equal the "
                  f"eager volume's and the program's ({want})")
    times = {"eager": [], "exported": []}
    for _ in range(EXPORT_TURNS):
        for arm in ("eager", "exported", "exported", "eager"):
            for canvas in canvases:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                if arm == "eager":
                    pred.predict_device(canvas)
                else:
                    run(pf, pc, canvas)
                ev[1].record()
                torch.cuda.synchronize()
                times[arm].append(ev[0].elapsed_time(ev[1]))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  {what}: device ms/vol, in turns: eager median {med['eager']:.3f} "
          f"(all {[round(t, 3) for t in times['eager']]}), exported median "
          f"{med['exported']:.3f} (all {[round(t, 3) for t in times['exported']]})"
          f" on {card}", flush=True)
    export_breakdown(what, {"eager": lambda: pred.predict_device(canvases[0]),
                            "exported": lambda: run(pf, pc, canvases[0])}, card)
    return med["eager"], med["exported"]


def export_breakdown(what, arms, card):
    """Where an exported volume's extra time goes: per arm, one volume under
    torch.profiler (the device kernels' time and launches, by name under
    OUT), and the host clock of one call until it returns (the launches
    issued) and until the card is done."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    got = {}
    for arm, fn in arms.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages() if _kernel_us(e) > 0),
                      key=_kernel_us, reverse=True)
        got[arm] = (sum(_kernel_us(e) for e in rows) / 1e3,
                    sum(e.count for e in rows), 1e3 * issued, 1e3 * done)
        os.makedirs(OUT, exist_ok=True)
        name = "".join(c if c.isalnum() else "_" for c in what)
        with open(os.path.join(OUT, f"export_profile_{name}_{arm}.txt"), "w") as f:
            for e in rows:
                f.write(f"{_kernel_us(e):12.1f} us  {e.count:5d}  {e.key}\n")
    print(f"  {what}: one volume, eager / exported: device kernels "
          f"{got['eager'][0]:.3f} / {got['exported'][0]:.3f} ms in "
          f"{got['eager'][1]} / {got['exported'][1]} launches (profiler); host "
          f"clock until the call returns {got['eager'][2]:.3f} / "
          f"{got['exported'][2]:.3f} ms, until the card is done "
          f"{got['eager'][3]:.3f} / {got['exported'][3]:.3f} ms on {card}",
          flush=True)


def phase11(exp, work, case_dirs, first, dev, card):
    """Phase 11: the program export (module docstring)."""
    import dataclasses

    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import export as export_cli
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer import export_hlo
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.train.checkpoint import CheckpointManager
    from brats2019_tpu_torch.utils.weights import build_unet

    t0 = time.perf_counter()
    # 11.1: the flagship export through the CLI, from checkpoints holding
    # phase 3's weights (the CLI re-exports the params from checkpoints)
    w11 = os.path.join(WORK, "export11")
    for stage, cfg in (("fine", exp.unet), ("coarse", exp.coarse_unet)):
        CheckpointManager(os.path.join(w11, stage)).maybe_save_best(
            0, build_unet(cfg, os.path.join(work, stage, "params.npz")), 0.0)
    t1 = time.perf_counter()
    rc, _ = run_cli(export_cli.main, ["--preset", "cascade", "--workdir", w11,
                                      "--stablehlo", "--stablehlo-check"])
    out = os.path.join(w11, "torch_export")
    man = json.load(open(os.path.join(out, "manifest.json")))
    check(rc == 0 and set(man["modules"]) == {"stage_roi", "stage_fine"}
          and man["checked"] is True and man["device"].startswith("cuda")
          and man["backend"] == "direct"
          and man["card"] == torch.cuda.get_device_name(0)
          and man["sm_count"] == torch.cuda.get_device_properties(0).multi_processor_count,
          f"export --preset cascade --stablehlo --stablehlo-check on the card: "
          f"exit code {rc}, modules {sorted(man['modules'])}, checked "
          f"{man['checked']}, device {man['device']} ({man['card']}, "
          f"{man['sm_count']} SMs), backend {man['backend']}, "
          f"{time.perf_counter() - t1:.1f} s; .pt2 bytes "
          f"{ {k: v['bytes'] for k, v in man['modules'].items()} }")
    pred = Predictor(exp, os.path.join(work, "fine", "params.npz"),
                     os.path.join(work, "coarse", "params.npz"), device=dev)
    canvases = [pred.prepare(load_case(d).image)[0] for d in case_dirs]
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    times = {"split cascade": exported_against_eager(
        "split cascade (stage_roi.pt2, stage_fine.pt2)", pred, out, canvases,
        calls, card)}
    print(f"  11.1 (the flagship export) took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 11.2: serve's program (the Winograd backend, device postprocessing)
    t1 = time.perf_counter()
    wexp = dataclasses.replace(exp, infer=dataclasses.replace(
        exp.infer, postproc="device"))
    ops.set_backend("winograd")
    try:
        wpred = Predictor(wexp, os.path.join(work, "fine", "params.npz"),
                          os.path.join(work, "coarse", "params.npz"), device=dev)
        wout = os.path.join(WORK, "export11_winograd")
        export_hlo.export_predict_program(wpred, wout, check=True)
        wman = json.load(open(os.path.join(wout, "manifest.json")))
        check(wman["backend"] == "winograd" and wman["postproc"] == "device"
              and wman["checked"] is True,
              f"serve's program exported: backend {wman['backend']}, postproc "
              f"{wman['postproc']}, checked {wman['checked']}")
        times["winograd, device postprocessing"] = exported_against_eager(
            "winograd + postproc=device", wpred, wout, canvases, calls, card,
            winograd=True)
    finally:
        ops.set_backend("direct")
    print(f"  11.2 (serve's program) took {time.perf_counter() - t1:.1f} s",
          flush=True)

    # 11.3: one predict.pt2 (cascade --no-tta: the monolithic program)
    t1 = time.perf_counter()
    mexp = dataclasses.replace(exp, infer=dataclasses.replace(
        exp.infer, tta_flips=False))
    mpred = Predictor(mexp, os.path.join(work, "fine", "params.npz"),
                      os.path.join(work, "coarse", "params.npz"), device=dev)
    mout = os.path.join(WORK, "export11_monolithic")
    written = export_hlo.export_predict_program(mpred, mout, check=True)
    check(type(mpred.program).__name__ == "Monolithic"
          and sorted(map(os.path.basename, written)) == ["manifest.json",
                                                        "predict.pt2"],
          f"cascade --no-tta exported as {sorted(map(os.path.basename, written))} "
          f"({type(mpred.program).__name__})")
    times["monolithic (cascade --no-tta)"] = exported_against_eager(
        "monolithic (predict.pt2)", mpred, mout, canvases, program_calls(mexp),
        card)
    print(f"  11.3 (predict.pt2) took {time.perf_counter() - t1:.1f} s",
          flush=True)
    for k, (e, x) in times.items():
        print(f"  exported program, device ms/vol (median, in turns): {k}: "
              f"eager {e:.3f}, exported {x:.3f} on {card}", flush=True)
    torch.cuda.empty_cache()
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)


# ----------------------------------------------------------------- phase 12 --

CC_REPLAYS = 20   # kernel calls replayed from one CUDA graph per reading


def phase12(exp, work, case_dirs, first, dev, card):
    """Phase 12: the device connected components on the whole canvas
    (module docstring). Returns the kernel table's record."""
    import dataclasses

    import numpy as np
    import torch
    from scipy import ndimage

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.ops import connected_components as cc
    from brats2019_tpu_torch.utils.weights import init_params

    t0 = time.perf_counter()
    sc = get_preset("single_chip")
    fine = init_params(sc.unet, SEED)
    preds = {pp: Predictor(dataclasses.replace(
        sc, infer=dataclasses.replace(sc.infer, postproc=pp)), fine, None,
        device=dev) for pp in ("host", "device")}
    canvases = [preds["host"].prepare(load_case(d).image)[0] for d in case_dirs]
    med = lambda v: sorted(v)[len(v) // 2]

    def events(fn, reps=1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    def plain_on_card(fg, *caps):
        return cc._label_plain(fg, *caps)

    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    times = {"kernel": [], "kernel eager": [], "plain": [], "plain wall": [],
             "scipy": []}
    errs = []
    for d, canvas in zip(case_dirs, canvases):
        labels, _ = preds["host"].predict_device(canvas)
        fg = (labels > 0).contiguous()
        passes, rounds = [], []
        real_pool, real_jump = cc._pool_passes, cc._jump_round
        cc._pool_passes = lambda lab, f, z, n: passes.append(n) or real_pool(lab, f, z, n)
        cc._jump_round = lambda *a: rounds.append(1) or real_jump(*a)
        try:
            want = cc._label_plain(fg, 192, 64, 8)
        finally:
            cc._pool_passes, cc._jump_round = real_pool, real_jump
        got = cc.label_components(fg)
        errs.append(int((got.long() - want.long()).abs().max()))
        fg_np = fg.cpu().numpy()
        n_comp = int(torch.unique(got).numel()) - 1
        check(got.dtype == torch.int32 and bool(torch.equal(got, want)),
              f"{os.path.basename(d)}: the kernel's ids on the canvas "
              f"{tuple(fg.shape)} ({int(fg_np.sum())} foreground voxels, "
              f"{n_comp} components) bitwise the plain form's, which took "
              f"{sum(passes)} pooling passes and {len(rounds)} jump rounds")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            cc.label_components(fg)
        for arm in ("plain", "kernel", "kernel", "plain"):
            if arm == "plain":
                times["plain"].append(events(lambda: cc._label_plain(fg, 192, 64, 8)))
                times["plain wall"].append(host_ms(lambda: cc._label_plain(fg, 192, 64, 8)))
            else:
                times["kernel"].append(events(graph.replay, CC_REPLAYS))
                times["kernel eager"].append(events(lambda: cc.label_components(fg)))
        t = time.perf_counter()
        ndimage.label(fg_np, structure=np.ones((3, 3, 3), bool))
        times["scipy"].append(1e3 * (time.perf_counter() - t))
        del graph
    n_vox = canvases[0].shape[0] * canvases[0].shape[1] * canvases[0].shape[2]
    bound = n_vox * (1 + 4) / 3.35e12 * 1e3   # the mask read, the ids written
    for k, v in times.items():
        print(f"  connected components on the canvas, {k}: median {med(v):.4f} "
              f"ms (all {[round(x, 4) for x in v]}) on {card}", flush=True)
    ops.reset_launch_counts()
    for canvas in canvases:
        preds["device"].predict_device(canvas)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["label_components"]
    check(launches == len(canvases),
          f"single_chip with postproc=device: label_components counted "
          f"{launches} calls for {len(canvases)} volumes")
    # the whole single_chip program with device postprocessing, the kernel
    # against the plain form on the same card, in turns
    prog = {"kernel": [], "plain": []}
    real_op = cc.label_components_op
    for arm in ("plain", "kernel", "kernel", "plain") * 2:
        cc.label_components_op = plain_on_card if arm == "plain" else real_op
        try:
            for canvas in canvases:
                prog[arm].append(events(lambda: preds["device"].predict_device(canvas)))
        finally:
            cc.label_components_op = real_op
    print(f"  single_chip program with postproc=device, device ms/vol in turns: "
          f"kernel median {med(prog['kernel']):.3f} (all "
          f"{[round(x, 3) for x in prog['kernel']]}), plain CC median "
          f"{med(prog['plain']):.3f} (all {[round(x, 3) for x in prog['plain']]}) "
          f"on {card}", flush=True)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)
    del preds
    torch.cuda.empty_cache()
    return {
        "name": "label_components", "route": "cuda",
        "source": "brats2019_tpu_torch/csrc/connected_components.cu",
        "replaces": "none (brats2019_tpu/ops/connected_components.py "
                    "label_components, plain lax.reduce_window propagation)",
        "launches": launches, "max_abs_err": float(max(errs)), "calls": 1,
        "unit": "vol", "ms": med(times["kernel"]), "plain_ms": med(times["plain"]),
        "wall_ms": med(times["kernel eager"]),
        "plain_wall_ms": med(times["plain wall"]),
        "bound_ms": bound, "bound_by": "bytes", "bound_bytes_ms": bound,
        "bound_operations_ms": 0.0, "library_ms": med(times["scipy"]),
        "library": "host scipy.ndimage.label (26-connectivity)",
    }


# ----------------------------------------------------------------- phase 13 --

# (grid, heads) of the Swin UNETR's four stages on a 128^3 tile: the padded
# grids 70^3, 35^3, 21^3, 14^3; batch 8 (the 8 flips of a tile)
SWIN_STAGES = [((64, 64, 64), 3), ((32, 32, 32), 6), ((16, 16, 16), 12),
               ((8, 8, 8), 24)]
SWIN_SHIFT = 3
SWIN_CASES = 2   # volumes of the Swin predictor run
WA_MAX, WA_MEAN = 2e-2, 4e-3   # kernel vs plain: max err / max, mean err / mean


def window_attention_inputs(dims, heads, shift, dev, n=8, seed=SEED):
    """(qkv bf16, table f32 at unit scale, window, shift) of one call."""
    import torch

    from brats2019_tpu_torch.ops.window_attention import padded, window_and_shift

    ws, ss = window_and_shift(dims, 7, shift)
    nw = n * math.prod(p // w for p, w in zip(padded(dims, ws), ws))
    g = torch.Generator(device=dev).manual_seed(seed + sum(dims) + shift)
    qkv = torch.randn(nw, math.prod(ws), 3 * heads * 16, generator=g, device=dev)
    table = torch.randn(13 ** 3, heads, generator=g, device=dev)
    return qkv.bfloat16(), table, ws, ss


def window_attention_library(qkv, table, dims, ws, ss, heads, scale):
    """``F.scaled_dot_product_attention`` with B + M materialised per window
    and head, a sample at a time (a sample's windows share them; the mask
    built outside what is timed)."""
    import torch
    import torch.nn.functional as F

    from brats2019_tpu_torch.ops.window_attention import (padded, relative_index,
                                                          shift_mask)

    t = math.prod(ws)
    b = table[relative_index(tuple(ws), 7).to(qkv.device).reshape(-1)]
    b = b.reshape(t, t, heads).permute(2, 0, 1)
    m = shift_mask(padded(dims, ws), tuple(ws), tuple(ss))
    m = torch.zeros(1, t, t) if m is None else m
    mask = (b[None] + m.to(qkv.device)[:, None]).bfloat16()
    q, k, v = qkv.reshape(qkv.shape[0], t, 3, heads, 16).permute(2, 0, 3, 1, 4)
    per = mask.shape[0]

    def run():
        for i in range(0, qkv.shape[0], per):
            sl = slice(i, i + per)
            F.scaled_dot_product_attention(q[sl], k[sl], v[sl], attn_mask=mask,
                                           scale=scale)
    return run, mask.numel() * 2


def phase13(dev, card):
    """The Swin UNETR's window attention (``csrc/window_attention.cu``,
    row 10): the kernel against the plain form at the four stages of a
    128^3 tile at batch 8, shifted and not (max error within WA_MAX of the
    largest output, mean error within WA_MEAN of the mean output, a repeat
    bitwise, one call and one kernel launch a call); device ms of each by
    CUDA-graph replay beside the plain form (CUDA events), SDPA with B + M
    materialised (the library call) and the call's bound (its qkv, table
    and output bytes over 3.35 TB/s, or 4 windows heads T^2 16 FLOPs over
    989 TFLOP/s); then the Swin Predictor (``perfbench/configs/
    swin_unetr.json``'s experiment, its seeded weights) on SWIN_CASES
    synthetic cases with the counters set to 0 just before: 96 calls a
    volume (12 tiles x 8 flips at batch 8, 8 blocks a forward), every one a
    launch of the kernel. Returns row 10 of the kernel record, per batch-8
    forward."""
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.ops.window_attention import window_attention_plain
    import numpy as np

    from perfbench import drivers, harness, synth

    t0 = time.perf_counter()
    rows, errs = [], []
    for dims, heads in SWIN_STAGES:
        for shift in (0, SWIN_SHIFT):
            qkv, table, ws, ss = window_attention_inputs(dims, heads, shift, dev)
            scale = 16 ** -0.5
            kern = lambda: ops.window_attention(qkv, table, dims, ws, ss, scale)
            plain = lambda: window_attention_plain(qkv.float(), table, dims, ws, ss,
                                                   scale)
            before = (ops.window_attention.launches, ops.window_attention.launches_cuda)
            got, again = kern(), kern()
            took = (ops.window_attention.launches - before[0],
                    ops.window_attention.launches_cuda - before[1])
            want = plain()
            torch.cuda.synchronize()
            err = (got.float() - want).abs()
            mx = err.max().item() / want.abs().max().item()
            mean = err.mean().item() / want.abs().mean().item()
            errs.append(err.max().item())
            what = f"window_attention at {dims}, heads {heads}, shift {ss}, batch 8"
            check(mx <= WA_MAX and mean <= WA_MEAN,
                  f"{what}: max err/max {mx:.3e} (<= {WA_MAX}), mean err/mean "
                  f"{mean:.3e} (<= {WA_MEAN})")
            check(torch.equal(got, again) and took == (2, 2),
                  f"{what}: a repeat bitwise {torch.equal(got, again)}, (calls, "
                  f"launches) {took} for 2 calls")
            del got, again, want
            library, mask_bytes = window_attention_library(qkv, table, dims, ws, ss,
                                                           heads, scale)
            nw, t = qkv.shape[:2]
            nbytes = (qkv.numel() + nw * t * heads * 16) * 2 + table.numel() * 4
            flops = 4 * nw * heads * t * t * 16
            row = {"dims": dims, "shift": ss, "windows": nw,
                   "ms": device_ms(kern, 5), "wall_ms": cuda_ms(kern, 5),
                   "plain_ms": cuda_ms(plain, 2), "library_ms": device_ms(library, 1),
                   "bytes_ms": 1e3 * nbytes / PEAK_BW,
                   "ops_ms": 1e3 * flops / PEAK_BF16, "mask_bytes": mask_bytes}
            rows.append(row)
            print(f"  {what}: kernel {row['ms']:.4f} ms (eager {row['wall_ms']:.4f}), "
                  f"plain {row['plain_ms']:.4f}, SDPA with B + M materialised "
                  f"({mask_bytes / 2 ** 20:.0f} MiB) {row['library_ms']:.4f}, bound "
                  f"{max(row['bytes_ms'], row['ops_ms']):.4f} (bytes "
                  f"{row['bytes_ms']:.4f}, FLOPs {row['ops_ms']:.4f}) on {card}",
                  flush=True)
            del qkv, library
            torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in ("ms", "wall_ms", "plain_ms",
                                                 "library_ms", "bytes_ms", "ops_ms")}
    bound = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows)
    print(f"  window_attention a batch-8 forward (8 calls): kernel {total['ms']:.4f} "
          f"ms, plain {total['plain_ms']:.4f}, SDPA with B + M {total['library_ms']:.4f}, "
          f"bound {bound:.4f} ({100 * bound / total['ms']:.2f}% of roofline) on {card}",
          flush=True)

    config = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                         "swin_unetr.json")))
    exp = harness.experiment(config)
    fine = drivers.flat_params(config["experiment"], SEED, dev)
    vols = synth.volumes(SWIN_CASES, (240, 240, 155), SEED, dev)
    pred = Predictor(exp, fine, None, device=dev)
    pred.predict_arrays_many(vols[:1])   # builds and warms every shape
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    labels = pred.predict_arrays_many(vols)
    torch.cuda.synchronize()
    calls = ops.launch_counts()["window_attention"]
    launches = ops.window_attention.launches_cuda
    want = 96 * SWIN_CASES
    check(calls == launches == want,
          f"Swin predictor on {SWIN_CASES} cases: window_attention calls {calls}, "
          f"kernel launches {launches} (expected {want})")
    vals = sorted({int(v) for lab in labels for v in np.unique(lab)})
    check(all(lab.shape == (240, 240, 155) for lab in labels)
          and set(vals) <= {0, 1, 2, 3, 4},
          f"Swin predictor labels: shapes {[lab.shape for lab in labels]}, values {vals}")
    del pred
    torch.cuda.empty_cache()
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {
        "name": "window_attention", "route": "cuda",
        "source": "brats2019_tpu_torch/csrc/window_attention.cu",
        "replaces": "none (the JAX package has no attention)",
        "launches": launches, "max_abs_err": float(max(errs)), "calls": len(rows),
        "unit": "forward", "ms": total["ms"], "plain_ms": total["plain_ms"],
        "wall_ms": total["wall_ms"], "plain_wall_ms": total["plain_ms"],
        "bound_ms": bound,
        "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
        "bound_bytes_ms": total["bytes_ms"], "bound_operations_ms": total["ops_ms"],
        "library_ms": total["library_ms"],
        "library": "F.scaled_dot_product_attention with B + M materialised",
        "stages": rows,
    }


def phase_alone(phase, exp, dev, card) -> int:
    """``--phases 9``, ``10``, ``11`` or ``12``: phase 3's weights, cases and
    predict CLI run (the masks the phase compares with), then that phase
    alone; no result lines."""
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.data import synthetic
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.utils.weights import init_params, save_params_npz

    shutil.rmtree(WORK, ignore_errors=True)
    work = os.path.join(WORK, "workdir")
    for stage, cfg, seed in (("fine", exp.unet, SEED),
                             ("coarse", exp.coarse_unet, SEED + 1)):
        os.makedirs(os.path.join(work, stage))
        save_params_npz(os.path.join(work, stage, "params.npz"),
                        init_params(cfg, seed))
    case_dirs = synthetic.write_dataset(os.path.join(WORK, "cases"), CASES,
                                        shape=VOLUME_SHAPE, seed0=SEED)
    rc = predict_cli.main([os.path.join(WORK, "cases"), "--preset", "cascade",
                           "--workdir", work, "--device", "cuda"])
    check(rc == 0, f"predict CLI exit code {rc}")
    print(f"== phase {phase} alone", flush=True)
    {9: phase9, 10: phase10, 11: phase11, 12: phase12}[phase](
        exp, work, case_dirs, read_labels(case_dirs), dev, card)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"== stopped after phase {phase} as asked; {len(FAILURES)} failure(s)",
          flush=True)
    for f in FAILURES:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if FAILURES else 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch port "
                                 "on one CUDA card; no argument runs it whole.")
    ap.add_argument("--phases", type=int, choices=(2, 5, 9, 10, 11, 12, 13), default=5,
                    help="2: stop after the kernel checks of phase 2; 9, 10, "
                         "11 or 12: phase 1, phase 3's cases, weights and "
                         "predict CLI run, then that phase alone; 13: phase 1, "
                         "then phase 13 (none of these prints result lines); "
                         "5 (default): everything")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data import synthetic
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.ops import _build, conv, norm, resize, winograd
    from brats2019_tpu_torch.ops import connected_components as cc
    from brats2019_tpu_torch.ops.window_attention import _lib as window_attention_lib
    from brats2019_tpu_torch.train.loop import stage_config
    from brats2019_tpu_torch.utils.weights import init_params, save_params_npz

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print("== phase 1: setup", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"device 0: {name}", flush=True)
    print(f"  card: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    # one nvcc each, side by side
    _build.build_all([conv._lib_wgmma, conv._lib, winograd._lib_wgmma,
                      winograd._lib, resize._lib, norm._lib, cc._lib, window_attention_lib]
                     + [lambda k=k: in_bwd_probe_lib(k) for k in range(5)])
    print(f"  built conv3d_wgmma.cu, conv3d.cu, winograd3d_wgmma.cu, "
          f"winograd3d.cu, resize2x.cu, in_act_bwd.cu (and its five probe "
          f"builds), connected_components.cu and window_attention.cu with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in ("conv3d_wgmma", "conv3d", "winograd3d_wgmma", "winograd3d",
                "resize2x", "in_act_bwd", "connected_components", "window_attention"):
        # registers, spills and warnings; not the per-function banners
        log = [ln.strip() for ln in
               _build.build_logs.get(lib, "(cached)").splitlines()
               if ln.strip() and "Compiling entry" not in ln
               and "Function properties" not in ln and "Compile time" not in ln
               and "(C7519)" not in ln]
        print(f"  ptxas, {lib}: " + " | ".join(log), flush=True)

    exp = get_preset("cascade")
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    coarse_canvas = stage_config(exp, "coarse")[1].pool_shape
    stage_calls = {
        "coarse": train_calls(exp.coarse_unet, 1, exp.train.coarse_patch),
        "fine": train_calls(exp.unet, 1, exp.train.patch),
    }
    eval_calls = (unet_calls(exp.coarse_unet, 1, coarse_canvas)
                  + unet_calls(exp.unet, 1, exp.train.pool_shape))
    if args.phases in (9, 10, 11, 12):
        return phase_alone(args.phases, exp, dev, card)
    if args.phases == 13:
        print("== phase 13 alone: the Swin UNETR's window attention", flush=True)
        phase13(dev, card)
        print(f"== stopped after phase 13 as asked; {len(FAILURES)} failure(s)",
              flush=True)
        for f in FAILURES:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1 if FAILURES else 0
    print("== phase 2: kernels vs plain torch at the flagship shapes", flush=True)
    t0 = time.perf_counter()
    wino_calls = [("conv3d_winograd", shape) for n, shape in calls if n == "conv3d"]
    library_for = (calls + wino_calls
                   + [c for c in stage_calls["fine"] if c[0] in BACKWARD])
    up_skips = {}   # the up backward's concat gradient: skip channels by shape
    for cfg, patch in ((exp.coarse_unet, exp.train.coarse_patch),
                       (exp.unet, exp.train.patch)):
        fwd = unet_calls(cfg, 1, patch)
        for i, (n_, sh) in enumerate(fwd):
            if n_ == "upsample2x":
                up_skips[sh] = fwd[i + 1][1][4] - sh[4]
    results = check_kernels(calls + stage_calls["coarse"] + stage_calls["fine"]
                            + eval_calls + GENERAL_CONV_CALLS + wino_calls
                            + GENERAL_WINO_CALLS + BWD_EDGE_CALLS, dev,
                            library_for, up_skips)
    for what, group in (("volume (predict)", calls),
                        ("fine train step", stage_calls["fine"]),
                        ("coarse train step", stage_calls["coarse"])):
        mine = [results[c] for c in group if c[0] == "conv3d"]
        print(f"  conv3d per {what}: {len(mine)} calls, wgmma kernel "
              f"{sum(r[2] for r in mine):.4f} ms, mma.sync kernel (prev) "
              f"{sum(r[9] for r in mine):.4f} ms, library call "
              f"{sum(r[8] or 0 for r in mine):.4f} ms"
              f"{'' if all(r[8] is not None for r in mine) else ' (not timed at every shape)'}"
              f", bound {sum(max(r[6], r[7]) for r in mine):.4f} ms on {card}",
              flush=True)
    pred_pairs = conv_norm_shapes(calls)
    partials = check_norm_partials(
        pred_pairs + conv_norm_shapes(stage_calls["coarse"])
        + conv_norm_shapes(stage_calls["fine"]) + conv_norm_shapes(eval_calls),
        dev, timed=set(pred_pairs))
    terms = {k: sum(partials[sh][k] for sh in pred_pairs)
             for k in ("merge_ms", "apply_ms", "epilogue_ms", "ms", "prev_ms",
                       "wall_ms")}
    in_bound = sum(max(results[c][6], results[c][7]) for c in calls
                   if c[0] == "instance_norm_act")
    print(f"  instance_norm_act per volume (predict), from the conv's partials: "
          f"{len(pred_pairs)} calls, merge {terms['merge_ms']:.4f} + apply "
          f"{terms['apply_ms']:.4f} + conv epilogue {terms['epilogue_ms']:.4f} "
          f"= {terms['ms']:.4f} ms, three launches (prev) "
          f"{terms['prev_ms']:.4f} ms, bound {in_bound:.4f} ms on {card}",
          flush=True)
    concat = check_up_concat(calls, dev)
    up = [results[c] for c in calls if c[0] == "upsample2x"]
    print(f"  upsample2x per volume (predict): {len(up)} calls, resize2x.cu "
          f"{sum(r[2] for r in up):.4f} ms, Triton kernel (prev) "
          f"{sum(r[9] for r in up):.4f} ms, bound "
          f"{sum(max(r[6], r[7]) for r in up):.4f} ms; up + skip concat "
          f"{sum(v[0] for v in concat.values()):.4f} ms against Triton up + "
          f"torch.cat {sum(v[1] for v in concat.values()):.4f} ms on {card}",
          flush=True)
    mine = [results[c] for c in wino_calls]
    print(f"  conv3d_winograd per volume (predict): {len(mine)} calls, wgmma "
          f"kernel {sum(r[2] for r in mine):.4f} ms, mma.sync kernel (prev) "
          f"{sum(r[9] for r in mine):.4f} ms, direct conv kernel "
          f"{sum(results[('conv3d', c[1])][2] for c in wino_calls):.4f} ms, "
          f"library call {sum(r[8] for r in mine):.4f} ms, bound "
          f"{sum(max(r[6], r[7]) for r in mine):.4f} ms on {card}", flush=True)
    # the f32 routes (F3): the accuracy config's forward at its TTA tile
    # batch, the smoke preset's train step, the unit preset's (C = 4: C % 8
    # != 0) train step
    acc_exp, smoke, unit = accuracy_exp(), get_preset("smoke"), get_preset("unit")
    f32_fwd = unet_calls(acc_exp.unet, 8, acc_exp.infer.tile)
    f32_train = train_calls(smoke.unet, 1, smoke.train.patch)
    unit_train = train_calls(unit.unet, 1, unit.train.patch)
    # each up backward reads the up half of its concat gradient at the
    # concat's pitch (smoke: C 16 of 24, C 32 of 48; unit: C 8 of 12)
    up_pitch = {sh: sh[4] + cs for cfg in (smoke, unit)
                for sh, cs in up_concats(unet_calls(cfg.unet, 1, cfg.train.patch))}
    f32_results = check_f32_kernels(f32_fwd + f32_train + unit_train, dev, up_pitch)
    check_f32_bwd_edges(dev)
    for what, group in (("accuracy-config tile batch (8, 32^3)", f32_fwd),
                        ("smoke train step (1, 64^3)", f32_train),
                        ("unit train step (1, 16^3)", unit_train)):
        for k in F32_SOURCE:
            mine = [f32_results[c] for c in group if c[0] == k]
            if mine:
                prev = ("" if any(r[9] is None for r in mine) else
                        f", its Triton form (prev) {sum(r[9] for r in mine):.4f} ms")
                print(f"  {k} f32 per {what}: {len(mine)} calls, kernel "
                      f"{sum(r[2] for r in mine):.4f} ms{prev}, plain "
                      f"{sum(r[3] for r in mine):.4f} ms, library call "
                      f"{sum(r[8] for r in mine):.4f} ms, bound "
                      f"{sum(max(r[6], r[7]) for r in mine):.4f} ms on {card}",
                      flush=True)
    # the fused f32 routes: IN statistics from the f32 conv's
    # epilogue at every f32 (conv, IN) pair, the f32 up into its concat
    f32_pairs = conv_norm_shapes(f32_fwd)
    f32_partials = check_f32_norm_partials(
        f32_pairs + conv_norm_shapes(f32_train) + conv_norm_shapes(unit_train),
        dev, timed=set(f32_pairs))
    f32_terms = {k: sum(f32_partials[sh][k] for sh in f32_pairs)
                 for k in ("merge_apply_ms", "two_launch_ms", "epilogue_ms", "ms",
                           "prev_ms", "wall_ms", "conv_ms")}
    print(f"  instance_norm_act f32 per accuracy-config tile batch, from the f32 "
          f"conv's partials: {len(f32_pairs)} calls, merge-apply "
          f"{f32_terms['merge_apply_ms']:.4f} (merge, then apply: "
          f"{f32_terms['two_launch_ms']:.4f}) + conv epilogue "
          f"{f32_terms['epilogue_ms']:.4f} = {f32_terms['ms']:.4f} ms "
          f"(the epilogue {100 * f32_terms['epilogue_ms'] / f32_terms['conv_ms']:.1f}% "
          f"of the f32 conv's {f32_terms['conv_ms']:.4f}), three launches (prev) "
          f"{f32_terms['prev_ms']:.4f} ms on {card}", flush=True)
    f32_concat = check_f32_up_concat(f32_fwd + f32_train + unit_train, dev)
    f32_ups = up_concats(f32_fwd)
    print(f"  upsample2x f32 per accuracy-config tile batch: {len(f32_ups)} "
          f"calls, up + skip concat on resize2x.cu "
          f"{sum(f32_concat[k][0] for k in f32_ups):.4f} ms against the Triton up "
          f"+ copy into the buffer (prev) {sum(f32_concat[k][1] for k in f32_ups):.4f} "
          f"ms on {card}", flush=True)
    floor_us = launch_floor(dev, card)
    bwd_terms = f32_bwd_breakdown(
        [sh for n_, sh in f32_train if n_ == "instance_norm_act_bwd"], dev, card,
        "smoke train step (1, 64^3)")
    # F3b: the f32 Winograd instance at the same f32 conv shapes
    f32_wino = check_f32_winograd(f32_fwd + f32_train, dev, f32_results)
    for what, group in (("accuracy-config tile batch (8, 32^3)", f32_fwd),
                        ("smoke train step (1, 64^3)", f32_train)):
        mine = [f32_wino[sh] for n, sh in group if n == "conv3d"]
        print(f"  conv3d_winograd f32 per {what}: {len(mine)} calls, kernel "
              f"{sum(r[2] for r in mine):.4f} ms, plain {sum(r[3] for r in mine):.4f} "
              f"ms, FFMA direct conv {sum(r[9] for r in mine):.4f} ms, cuDNN f32 "
              f"{sum(r[8] for r in mine):.4f} ms, bound "
              f"{sum(max(r[6], r[7]) for r in mine):.4f} ms on {card}", flush=True)
    print(f"  phase 2 took {time.perf_counter() - t0:.1f} s; device memory "
          f"still allocated after it: "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB", flush=True)
    if args.phases == 2:
        print(f"== stopped after phase 2 as asked; {len(FAILURES)} failure(s)",
              flush=True)
        return 1 if FAILURES else 0

    print("== phase 3: the cascade predict slice on the card", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    work = os.path.join(WORK, "workdir")
    for stage, cfg, seed in (("fine", exp.unet, SEED),
                             ("coarse", exp.coarse_unet, SEED + 1)):
        os.makedirs(os.path.join(work, stage))
        save_params_npz(os.path.join(work, stage, "params.npz"),
                        init_params(cfg, seed))
    t0 = time.perf_counter()
    case_dirs = synthetic.write_dataset(os.path.join(WORK, "cases"), CASES,
                                        shape=VOLUME_SHAPE, seed0=SEED)
    print(f"  wrote {CASES} synthetic {VOLUME_SHAPE} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cli_args = [os.path.join(WORK, "cases"), "--preset", "cascade",
                "--workdir", work, "--device", "cuda"]

    ops.reset_launch_counts()
    rc = predict_cli.main(cli_args)
    counts = ops.launch_counts()
    on_wgmma = ops.conv3d.launches_wgmma
    routes = {"conv3d with the statistics epilogue": ops.conv3d.launches_stats,
              "instance_norm_act from partials":
                  ops.instance_norm_act.launches_partials,
              "upsample2x on resize2x.cu": ops.upsample2x.launches_cuda,
              "upsample2x into the concat buffer": ops.upsample2x.launches_concat}
    check(rc == 0, f"predict CLI exit code {rc}")
    per_vol = {k: v / CASES for k, v in counts.items()}
    expect = {k: sum(1 for n, _ in calls if n == k) for k in FORWARD}
    print(f"  launches on the slice: {counts} ({per_vol} per volume; "
          f"expected per volume {expect})", flush=True)
    for k in FORWARD:
        check(counts[k] > 0 and counts[k] == expect[k] * CASES,
              f"{k} launched {counts[k]} times on the slice")
    check(on_wgmma == counts["conv3d"],
          f"{on_wgmma} of the {counts['conv3d']} conv launches took the wgmma "
          f"instance (conv3d_wgmma.cu)")
    want = {"conv3d with the statistics epilogue": counts["conv3d"],
            "instance_norm_act from partials": counts["instance_norm_act"],
            "upsample2x on resize2x.cu": counts["upsample2x"],
            "upsample2x into the concat buffer": counts["upsample2x"]}
    check(routes == want, f"routes on the slice: {routes} (expected {want})")
    first = read_labels(case_dirs)
    for d, seg in zip(case_dirs, first):
        vals = sorted(int(v) for v in set(seg.ravel().tolist()))
        check(seg.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4},
              f"{os.path.basename(d)}: shape {seg.shape}, labels {vals}")
    rc = predict_cli.main(cli_args)
    check(rc == 0, f"repeat predict CLI exit code {rc}")
    for d, a, b in zip(case_dirs, first, read_labels(case_dirs)):
        check(a.shape == b.shape and bool((a == b).all()),
              f"{os.path.basename(d)}: repeat run bitwise equal")
    small_reference(exp, work, dev)
    serial_e2e = time_slice(exp, work, case_dirs, dev, card)

    print("== phase 4: the cascade training slice on the card", flush=True)
    t0 = time.perf_counter()
    train_counts = train_slice(os.path.join(WORK, "cases"), case_dirs,
                               stage_calls)
    step_reference(exp, dev)
    time_training(exp, dev, card, results, stage_calls)
    print(f"  phase 4 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 5: the serving slice on the card (Winograd conv backend, "
          "device postprocessing, HTTP)", flush=True)
    t0 = time.perf_counter()
    serve_counts = serve_slice(work, case_dirs, first, expect, serial_e2e,
                               exp.infer.serving_depth, card)
    backend_ms = time_backends(exp, work, case_dirs, dev, card)
    print(f"  phase 5 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 6: the other predict programs on the card", flush=True)
    t0 = time.perf_counter()
    other_programs(work, case_dirs, dev, card)
    print(f"  phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 7: the accuracy slice (f32 presets, the accuracy arms at "
          "f32, the flagship ensemble, evaluate, the ensemble daemon)", flush=True)
    t0 = time.perf_counter()
    (f32_train_counts, _, _), wino_f32_launches = f32_presets_slice()
    f32_fwd_counts = accuracy_on_card(dev, card)
    flagship_ensemble(exp, work, case_dirs, first, dev, card)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 8: the training left-outs at the flagship fine width "
          "(distillation, deep supervision and remat, warm start and the "
          "importer, prep cache, sanitizers, profile, info)", flush=True)
    t0 = time.perf_counter()
    training_leftouts(exp, os.path.join(WORK, "cases"), case_dirs, dev, card,
                      unet_calls(exp.unet, 1, exp.train.patch), stage_calls["fine"])
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 9: the native decoder, the params export, the mesh modes, "
          "data parallelism and the multi-process launcher", flush=True)
    phase9(exp, work, case_dirs, first, dev, card)

    print("== phase 10: volume pairing, the int8 transfer, the RSS recycle, "
          "KD over cuda:0 and the CPU", flush=True)
    phase10(exp, work, case_dirs, first, dev, card)

    print("== phase 11: the program export (torch.export over the kernel "
          "operators)", flush=True)
    phase11(exp, work, case_dirs, first, dev, card)

    print("== phase 12: the device connected components on the whole canvas",
          flush=True)
    cc_record = phase12(exp, work, case_dirs, first, dev, card)

    print("== phase 13: the Swin UNETR's window attention and its predictor",
          flush=True)
    wa_record = phase13(dev, card)

    record = []
    for k, (route, source, replaces) in KERNELS.items():
        errs = [r[1] for (n, _), r in results.items() if n == k]
        if k in FORWARD:
            # per volume: the predict slice's calls of this kernel, summed
            mine = [results[(n, shape)] for n, shape in calls if n == k]
            launches = counts[k]
        elif k == "conv3d_winograd":
            # per volume: the serving slice's calls of this kernel, summed
            mine = [results[c] for c in wino_calls]
            launches = serve_counts[k]
        else:
            # per fine train step: the step's calls of this kernel, summed
            mine = [results[c] for c in stage_calls["fine"] if c[0] == k]
            launches = train_counts[k]
        times = tuple(sum(r[i] for r in mine) for i in (2, 3, 4, 5))
        bytes_ms, ops_ms = (sum(r[i] for r in mine) for i in (6, 7))
        record.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs),
            "ms": times[0], "plain_ms": times[1],
            "bound_ms": sum(max(r[6], r[7]) for r in mine),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sum(r[8] for r in mine),
            "wall_ms": times[2], "plain_wall_ms": times[3],
            "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
            "calls": len(mine),
        })
        if k in PREV_SOURCE:
            record[-1]["prev_ms"] = sum(r[9] for r in mine)
            record[-1]["prev_source"] = PREV_SOURCE[k]
        if k == "instance_norm_act":
            # the predict path's route: merge + apply + the conv's epilogue
            record[-1].update(
                ms=terms["ms"], wall_ms=terms["wall_ms"],
                max_abs_err=max(partials[sh]["abs_err"] for sh in partials),
                prev_ms=terms["prev_ms"],
                prev_source="brats2019_tpu_torch/ops/triton_norm.py (three launches)",
                merge_ms=terms["merge_ms"], apply_ms=terms["apply_ms"],
                epilogue_ms=terms["epilogue_ms"],
                epilogue_source=EPILOGUE_SOURCE)
    for k, (route, source) in F32_SOURCE.items():
        # per accuracy-config tile batch (forward) or smoke train step
        # (backward); launches on phase 7's accuracy arms or f32 training
        fwd = k in FORWARD
        mine = [f32_results[c] for c in (f32_fwd if fwd else f32_train) if c[0] == k]
        bytes_ms, ops_ms = (sum(r[i] for r in mine) for i in (6, 7))
        record.append({
            "name": f"{k}_f32", "route": route, "source": source,
            "replaces": KERNELS[k][2],
            "launches": (f32_fwd_counts if fwd else f32_train_counts)[k][1],
            "max_abs_err": max(r[1] for (n, _), r in f32_results.items() if n == k),
            "ms": sum(r[2] for r in mine), "plain_ms": sum(r[3] for r in mine),
            "bound_ms": sum(max(r[6], r[7]) for r in mine),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sum(r[8] for r in mine),
            "wall_ms": sum(r[4] for r in mine), "plain_wall_ms": sum(r[5] for r in mine),
            "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
            "calls": len(mine),
            "unit": "accuracy-config tile batch" if fwd else "smoke train step",
        })
        if k in F32_PREV_SOURCE:
            record[-1]["prev_source"] = F32_PREV_SOURCE[k]
            if k != "instance_norm_act":
                # the Triton form on the same inputs, in the same run
                record[-1]["prev_ms"] = sum(r[9] for r in mine)
        if k == "instance_norm_act":
            # the f32 path's route: merge + apply + the f32 conv's epilogue
            record[-1].update(
                ms=f32_terms["ms"], wall_ms=f32_terms["wall_ms"],
                max_abs_err=max(r["abs_err"] for r in f32_partials.values()),
                prev_ms=f32_terms["prev_ms"],
                merge_apply_ms=f32_terms["merge_apply_ms"],
                two_launch_ms=f32_terms["two_launch_ms"],
                epilogue_ms=f32_terms["epilogue_ms"],
                epilogue_source=F32_EPILOGUE_SOURCE)
        if k == "upsample2x":
            # as the decoder runs it, into the concat buffer, against the
            # Triton up + copy
            record[-1].update(
                concat_ms=sum(f32_concat[u][0] for u in f32_ups),
                concat_prev_ms=sum(f32_concat[u][1] for u in f32_ups),
                launch_floor_us=floor_us["up (resize2x.cu)"])
        if k == "downsample2x":
            record[-1].update(launch_floor_us=floor_us["down (resize2x.cu)"],
                              prev_launch_floor_us=floor_us["down (Triton)"])
        if k in ("upsample2x_bwd", "downsample2x_bwd"):
            what = "up backward" if k == "upsample2x_bwd" else "down backward"
            record[-1].update(launch_floor_us=floor_us[f"{what} (resize2x.cu)"],
                              prev_launch_floor_us=floor_us[f"{what} (Triton)"])
        if k == "instance_norm_act_bwd":
            record[-1]["breakdown_ms"] = bwd_terms
    # F3b: the f32 Winograd instance, per accuracy-config tile batch; launches
    # on phase 7's Winograd-backend predicts of unit and smoke
    mine = [f32_wino[sh] for n, sh in f32_fwd if n == "conv3d"]
    bytes_ms, ops_ms = (sum(r[i] for r in mine) for i in (6, 7))
    record.append({
        "name": "conv3d_winograd_f32", "route": "cuda", "source": F32_WINO_SOURCE,
        "replaces": KERNELS["conv3d_winograd"][2], "launches": wino_f32_launches,
        "max_abs_err": max(r[1] for r in f32_wino.values()),
        "ms": sum(r[2] for r in mine), "plain_ms": sum(r[3] for r in mine),
        "bound_ms": sum(max(r[6], r[7]) for r in mine),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(r[8] for r in mine),
        "wall_ms": sum(r[4] for r in mine), "plain_wall_ms": sum(r[5] for r in mine),
        "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
        "calls": len(mine), "unit": "accuracy-config tile batch",
        "direct_ms": sum(r[9] for r in mine),
        "direct_source": "brats2019_tpu_torch/csrc/conv3d.cu (conv3d_ndhwc_f32)",
    })
    record.append(cc_record)   # per volume of single_chip, on the whole canvas
    record.append(wa_record)   # per batch-8 forward of the Swin UNETR
    for r in record:
        unit = r.get("unit") or ("fine train step" if r["name"] in BACKWARD
                                 else "vol")
        print(f"  {r['name']}: {r['calls']} calls/{unit}, device {r['ms']:.4f} "
              f"ms/{unit} in kernels"
              + (f" (prev: {r['prev_ms']:.4f})" if "prev_ms" in r else "")
              + f" vs {r['plain_ms']:.4f} plain torch, "
              f"library call {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']} (bytes {r['bound_bytes_ms']:.4f}, operations "
              f"{r['bound_operations_ms']:.4f}); wall {r['wall_ms']:.4f} vs "
              f"{r['plain_wall_ms']:.4f}; {r['launches']} launches on its "
              f"slice, on {card}", flush=True)
    print(f"  whole predict program, device ms/vol: direct "
          f"{backend_ms['direct']:.3f}, winograd {backend_ms['winograd']:.3f} "
          f"on {card}", flush=True)
    print(f"== done in {time.perf_counter() - t_start:.1f} s; "
          f"{len(FAILURES)} failure(s)", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    if FAILURES:
        for f in FAILURES:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
