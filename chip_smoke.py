#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``posetpu_torch`` beside it).
Phases, each of which fails the run on its own:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device -> exit 1;
2. build every CUDA kernel from ``posetpu_torch/csrc`` (one nvcc per source,
   all started together), printing the build time and ptxas' report;
3. eleven paths at full width. Paths 1-8: ResNet-50, 256x256 input, 4 views,
   16 joints, 64x64 heatmaps, the S=4096 aggregation bank, random weights
   from a seed, calibrated on 2 batches; each serving path serves a few
   requests through prepare -> infer -> triangulate_points, the first warms
   up and frames/s is over the rest. Path 9 takes no model. Every kernel's
   launch count is set to 0 just before a path and read just after: each
   kernel of the path must have launched.
   - path 1, the defaults: ``build_serving_pipeline``, 32 four-view groups
     (128 images) per request: B2, B1, B3 (and B3's quantize pass); 8 timed
     requests, frames/s as the median and the min-max over them; its
     profiled request must show B2 as one launch of ``tail2_kernel``'s
     phase-major instance, B1 as two launches of its instances (z2 stays on
     chip) and no other ``tail2_kernel`` instance;
   - path 2: ``build_serving_pipeline(flip_test="premirrored",
     agg_w4=True)``, 32 groups, so 256 images through the trunk: B2, B1, B4
     (and B3's quantize pass); 8 timed requests; its profiled request must
     show B2's and B1's instances alone among ``tail2_kernel``'s, B4's
     ``aggregation_w4_kernel`` and one ``quantize_kernel``, and no
     ``aggregation_s4_kernel``; one request with ``flip_test=True`` must give
     equal preds and maxvals;
   - path 3: ``quantize_pose_resnet(jns_head="phase", phase_kernel=1,
     stem_s2d="pre", act4_mode="s4", subpixel_deconvs={"deconv0"})`` with
     ``SUBPIX_BATCHED = False``, the levels=1 tables, the int8 bank, decode
     and triangulation, 8 groups: B6, B5 (and B3); deconv1 runs the dilated
     int8 conv; its profiled request must show B6's and B5's ``tail2_kernel``
     instances once each and no other, one ``quantize_kernel`` and one
     ``aggregation_kernel``;
   - path 4: ``build_float_pipeline(flip_test=True)``, 8 groups: B7;
   - path 5a: ``quantize_pose_resnet(model, calib)`` at its defaults (the
     JAX package's) then ``make_fused_forward(model, qparams)``: float
     normalised [N, 256, 256, 3] input, pinned on the host once and uploaded
     with ``non_blocking`` each request, 32 groups, heatmaps [G, V, J, h, w]
     -> ``final_preds`` (B7) -> ``triangulate_points``: B9a x2 and B9b x1 per
     forward (``tail2_kernel``'s B9 instances: deconv0 on the streamed halo,
     deconv1 and deconv2 + head on the resident one); 8 timed requests,
     frames/s as the median and the min-max over them;
   - path 5b: ``make_fused_forward(model, qparams, pallas_blocks=True)``:
     B8a x13, B9a x2, B9b x1 per forward, 8 timed requests; one request is
     profiled, and must show each B9 launch under its instance's name;
   - path 5c: path 5b with the 12 identity blocks sent to B8b (``imgs=2``)
     by this script (no entry point of the package routes there): the A/B of
     the two bottleneck kernels end to end; its profiled request must show
     12 launches of ``bottleneck_v2_kernel`` and one of
     ``bottleneck_rows_kernel``;
   - the int8 runner's own forward on the same input, for frames/s beside
     5a-5c, and the fused forwards' heatmaps and decoded joints against it;
   - path 6, ``bench.py``'s S-minor tail with the flip test
     (``_build_int8(tail="jns", flip_test=True)``) ported:
     ``quantize_pose_resnet(jns_head=True)`` (the runner's trunk and dilated
     deconvs) on the images and their mirror in one batch,
     ``flip_test_merge_jns``, the per-pair int8 bank
     (``quantize_aggregation`` + ``aggregation_int8_apply_jns``),
     ``fuse_routing_jns``, ``final_preds_jns`` and triangulation, 32 groups,
     8 timed requests: B7; its profiled request must show B7 once and no
     other hand kernel;
   - one request of path 1 through ``build_serving_pipeline(aggre_kernel=
     False)`` (the plain aggregation, ``torch._int_mm`` on gathered
     operands, no B3 launch) on path 1's params and input: preds and maxvals
     equal to path 1's;
   - path 7, ``bench.py:546 _build_train`` ported: the ResNet-50
     MultiViewPose with the bank, ``dtype=torch.bfloat16``, MSE +
     consistency + fundamental loss (the camera ring's F bank), Adam at
     1e-3, 32 four-view groups of 256x256 (64x64 heatmaps, 16 joints); 3
     warm-up steps and 10 timed ones chained through the state: groups/s and
     images/s (median and min-max of the steps' CUDA-event times), peak
     memory, every step's loss finite, and one profiled step (device busy
     ms, idle share, time by kernel family); no hand kernel is on this path;
   - path 8, the adversarial step (``make_adversarial_train_step``): the
     ResNet-50 MultiViewPose without the bank in f32 (TF32 convolutions,
     PyTorch's default), the five critics (``build_discriminators``) and the
     fundamental loss, :func:`gan_config`'s losses, 8 four-view groups of
     256x256 a step (half of them h36m), the samplers' draws from a seeded
     generator on the card; 3 warm-up steps, then 10 of each parity in turn
     chained through the states: groups/s a parity (median and min-max of
     the CUDA-event times), peak memory, every metric finite, every Adam
     count (the base's and each critic's) equal to the steps taken, no hand
     kernel launched; one profiled step of each parity by family;
   - path 9, the 3D and pseudo-label stages (:func:`path9`): 16,384
     four-view groups of ``make_skeleton_poses`` seen by
     ``make_camera_ring()`` (1000x1000, distortion), cropped as the H36M
     annotation does (256x256 input, 64x64 maps, sigma 2), rendered in
     chunks of 4,096 images, each map scaled by a seeded confidence, one
     view of 10 % of the group-joints moved ~75-150 px; decoded by
     ``final_preds`` (B7, one launch a chunk, no other hand kernel);
     ``mint_pseudo_labels`` at thresholds 0.6-0.9, RANSAC with 3 inliers at
     10 px, reprojection (its device sweep alone where h5py is absent);
     each entry's PCKh and vis; RANSAC's and the reprojection's ms per
     threshold over all groups (CUDA events), the planted outliers it drops
     and the clean views it keeps; ``triangulate_poses`` on the GT 2D (under
     1 mm) and on the decoded 2D; ``rpsm`` at test_rpsm.yaml's PICT_STRUCT on
     64 groups rendered in H36M's projection (MPJPE under 60 mm, max under
     150), its ms a group and peak memory;
   - path 10, the train CLI on images (:func:`path10`): an image fixture
     written at the start (``data/synthetic.write_image_fixture``: 64 MPII
     JPEGs of 1280x720 and 64 H36M JPEGs of 1000x1000 in zips, the
     reference's annotation files), then ``cli/train.py``'s ``setup`` and
     epoch loop (``train_epochs``: train, validate, checkpoints) for one
     epoch of experiments/mpii/resnet50/140e_32batch.yaml (bf16 R50, 8
     groups a batch, MPII's augmentation, validate with the flip test) and
     then of experiments/mixed/resnet50/256_nofusion_fund5.yaml warm-started
     from step 1's ``final_state`` (the fundamental loss from the fixture's
     cameras, validate on H36M); the validate H5 dump where h5py is
     present. Each step's main path must launch B7 once a validate batch and
     nothing else; its line gives the loop's groups/s (host clock, loader
     included), the step alone on 8 batches held on the card (CUDA events),
     the loader alone a batch and the host ms an image, the StepTimer's data
     ms, 5 loop steps profiled (device busy, idle share), validate's
     groups/s, peak memory, checkpoint ms, the first and last loss; checks:
     two passes over one epoch seed and prefetch 0 against 2 give equal
     bytes, ``prepare`` card vs CPU (images within 2 ulp, targets 1e-6),
     validate on one group card vs CPU in f32 (loss 1e-4, maxvals 1e-3, 90 %
     of the joints within 1e-3 px), every loss finite, step 2 holding step
     1's weights and its first loss below a fresh model's on that batch;
   - path 11, serving a trained checkpoint (:func:`path11`) on path 10's
     fixture (24 H36M validation groups, 8 a batch): 11a,
     ``cli.validate.run`` on path 10's step-2 ``final_state`` at the CLI's
     defaults (the bf16 R50) and with ``--int8 --calib-batches 2
     --int8-act4 l12 --int8-subpixel deconv0 --flip-test`` (and in float
     with ``--flip-test``): perf, the int8 preds' largest and mean pixel
     distance from the float ones (at the defaults, and both with the flip
     test), the seconds to calibrate and quantize, validate's groups/s
     (host clock around the loop, ending in a synchronize; the process is
     warm), B7's launches and peak memory; 11b, a reference-layout
     ``final_state.pth.tar`` written from a seed (:func:`reference_checkpoint`: R50 and the 12
     ChannelWiseFC at 4096x4096, 805 MB in f32), ``cli.convert`` of it,
     then ``cli.validate --int8 --qat-steps 4 --calib-batches 2
     --flip-test`` on the result under experiments/mixed/resnet50/
     256_fusion.yaml (the bank's bf16 product and fuse routing on): the
     four QAT losses, each QAT step's ms (CUDA events), the write, convert
     and load seconds, groups/s and perf. Each run's main path must launch
     B7 once a validate batch and nothing else;
4. each kernel against its plain PyTorch version on the card, on the inputs
   its path gives it (taken from one more request): outputs must be equal.
   Timed with CUDA events (3 warm-up calls, median of 20): the kernel, its
   plain version, and where PyTorch computes the same products a
   yardstick (B3, B4: 4 ``torch._int_mm`` calls on pre-gathered operands,
   the 4-bit bank widened to int8, both also their GEMM kernel alone; the
   phase-form deconvs B1, B2, B5, B6, B9a and B9b: per phase one
   ``torch._int_mm`` on the four shifted taps gathered beforehand, and for
   a head one more on its int8 input: the GEMMs alone; B8a and B8b: one
   each for conv1 on x, conv2 on h1's im2col patches, conv3 on h2 (and the
   projection), gathered beforehand; B7: ``torch.max`` over the maps
   flattened, from the same input). B7 runs
   at path 4's 512 maps (the numbers of its ``kernels`` entry) and at path
   5b's 2,048, with the wrapper's host time per call beside ``torch.max``'s.
   B7 also runs on one validate batch of each path-10 step and on one int8
   validate batch of path 11 (512 maps each).
   B8a runs on each of the 13 block inputs path 5b gives it (its time is
   their sum; each line carries the block shape its planner chose: rows per
   block, ring stages, staging tiles, shared memory, blocks per SM,
   registers) and each block is also held within one int8 step of the
   runner's block on the same input; B2 on path 1's 128 images (the numbers
   of its ``kernels`` entry) and on path 2's 256; B6 on path 3's 32 images
   (its entry's numbers) and on B2's 128-image input; B5 on path 3's 32
   images (its entry's numbers) and on the same input four times over (128
   images, B9b's shape, timed beside B9b); B9a on both its deconvs
   (the kernels line carries each call's case, with its design, and their
   sum); B8b on path 5c's 12 inputs, equal to its plain version and to
   B8a's output, each line with the block its planner chose, then per
   layer B8b's, B8a's and the yardstick's ms on the same inputs;
5. card vs CPU on one group through the same port on ``device="cpu"`` with
   the same params, for path 1 and path 2 (the s4 bank): maxvals equal,
   preds within atol 1e-4 (the inverse affine's tiny matmul may round
   differently); for path 4, whose float convolutions sum in another order
   on the card: maxvals within atol 1e-3 and at least 90 % of the joints
   within 1e-3 px (a near-tie may move a peak or flip a nudge); for path
   5b: heatmaps equal; for path 6: maxvals equal, preds within atol 1e-4;
   for path 7, one f32 train step of a ResNet-18 at 64x64 on 2 groups (TF32
   off, as on the CPU): the loss within rtol 1e-4, the gradients within a
   relative L2 difference of 2e-2 per parameter and a cosine above 0.9999
   over all of them (train-mode BN amplifies the two backends' rounding; the
   CPU tests hold the port to JAX the same way); for path 8, one f32 step of
   each parity of its configuration at ResNet-18, 64x64, 4 groups (TF32
   off; 2 groups make the view and joints critics' BatchNorm degenerate),
   trained-like base weights, the CPU's draws fed to both: the loss within
   rtol 1e-4, and per model (the base and each critic) path 7's gradient
   bounds or three times the CPU's own distance under a 1e-7 nudge of the
   images, where that is larger (:func:`gan_card_vs_cpu`); for path 9, on 64
   groups: RANSAC's res_vis equal, the reprojection within 1e-3 px, and one
   group's RPSM pose within 1 mm a joint (:func:`path9_card_vs_cpu`); for
   path 11, one QAT step at ResNet-18 (:func:`qat_card_vs_cpu`: in float64
   the loss within 1e-4 relative and at most 0.1 % of the int8 weights off
   by one; the float32 numbers reported) and the int8 eval step on one group
   of 11a and of 11b through the same qparams (:func:`eval_step_card_vs_cpu`:
   without the bank heatmaps and maxvals equal and preds within 1e-4 px;
   with the bf16 bank within one bf16 step).

The last lines are the card line, one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet): int8 tensor cores and HBM3
PEAK_INT8_OPS = 1.979e15
PEAK_F32_OPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

GROUPS, VIEWS = 32, 4
SMALL_GROUPS = 8  # paths 3 and 4
PATH5A = "path 5a (fused deconvs + head)"
PATH5B = "path 5b (fused blocks, deconvs + head)"
PATH5C = "path 5c (5b, identity blocks through B8b)"
PATH6 = "path 6 (S-minor tail, flip test, per-pair bank)"
TRAIN_WARMUP, TRAIN_STEPS = 3, 10  # path 7
GAN_GROUPS, GAN_WARMUP, GAN_STEPS = 8, 3, 10  # path 8: timed steps of each parity
# path 9: four-view groups of skeletons through decode, the pseudo-label sweep
# and triangulation; RPSM on the first RPSM_GROUPS; card vs CPU on CHECK_GROUPS
PATH9 = "path 9 (3D and pseudo-label stages)"
G9, RPSM_GROUPS, CHECK_GROUPS = 16384, 64, 64
RENDER_CHUNK = 4096  # images of maps rendered and decoded at once (1.07 GB of f32)
OUTLIER_SHARE = 0.1  # of the group-joints: one view's peak moved 40-80 crop px
THRESHOLDS = (0.6, 0.7, 0.8, 0.9)
# path 9's RANSAC bounds at threshold 0.6, set from the first chip run that
# measured them: 0.9995 of the planted outliers dropped, 0.9223 of the clean
# views kept (PERF.md)
MIN_OUTLIERS_DROPPED, MIN_CLEAN_KEPT = 0.995, 0.90
# path 10: the train CLI on an image fixture, MPII pretraining then the mixed
# retrain from its final_state; batches held on the card for the step alone,
# loop steps profiled
PATH10 = "path 10 (train CLI: MPII pretraining, then the mixed retrain)"
PATH10_PRESETS = ("experiments/mpii/resnet50/140e_32batch.yaml",
                  "experiments/mixed/resnet50/256_nofusion_fund5.yaml")
HELD_BATCHES, PROFILED_STEPS = 8, 5
# path 11: serving path 10's checkpoint (11a) and a converted reference one
# with QAT and the bank (11b) through the validate and convert CLIs
PATH11 = "path 11 (serving a trained checkpoint: validate, convert, int8, QAT)"
PATH11_PRESET = "experiments/mixed/resnet50/256_fusion.yaml"
# a full-f32 pass of the card's QAT step against float64, relative to its
# largest magnitude (TF32 rounds each product's operands to 10 bits)
F32_PASS_BOUND = 1e-5
EVAL_ITERS = 30  # path 11's eval step alone on one held batch
# path 9's kernel families by name (PyTorch's own kernels)
PATH9_FAMILIES = {"reductions (sum, max, argmax)": ("reduce_kernel",),
                  "gather / index": ("gather", "index", "scatter"),
                  "elementwise": ("elementwise",),
                  "memcpy/memset": ("Memcpy", "Memset")}

# path 7's kernel families by name (cuDNN's bf16 kernels carry "xmma" too)
TRAIN_FAMILIES = {"convolutions (cuDNN)": ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                                           "implicit", "xmma"),
                  "GEMMs (cuBLAS: the bank, the head)": ("gemm", "Gemm", "cutlass"),
                  "BatchNorm": ("batch_norm", "bn_", "welford"),
                  "optimizer (foreach)": ("foreach", "multi_tensor"),
                  "memcpy/memset": ("Memcpy", "Memset")}
# path 11's eval steps: the int8 trunk's GEMMs (torch._int_mm, a cutlass
# "i161616gemm_s8" kernel), the float trunk's convolutions (cuDNN's are
# named "...cudnn...fprop..." or "..._fprop_implicit_gemm_..."), then
# cuBLAS's other GEMMs; the first match counts
PATH11_FAMILIES = {"decode (B7)": ("decode_kernel",),
                   "int8 GEMMs (torch._int_mm)": ("gemm_s8", "igemm", "imma"),
                   "convolutions (cuDNN)": ("cudnn", "fprop", "dgrad", "implicit_gemm"),
                   "BatchNorm": ("batch_norm", "bn_"),
                   "other GEMMs (cuBLAS)": ("gemm", "Gemm", "cutlass"),
                   "memcpy/memset": ("Memcpy", "Memset")}
# path 8's: the critics' dense layers are cuBLAS's f32 GEMMs, named
# "sm80_xmma_gemm_f32f32..." or cutlass "sgemm" (so "xmma" alone does not
# mark a convolution here); the samplers' multinomial and top-k kernels
GAN_FAMILIES = {"convolutions (cuDNN)": ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                                         "implicit"),
                "GEMMs (cuBLAS: the critics, the head)": ("gemm", "Gemm", "cutlass", "gemv"),
                "BatchNorm": TRAIN_FAMILIES["BatchNorm"],
                "samplers (multinomial, top-k)": ("multinomial", "topk", "sort", "Sort",
                                                  "radix", "bitonic", "sampleMultinomial"),
                "optimizer (foreach)": TRAIN_FAMILIES["optimizer (foreach)"],
                "memcpy/memset": TRAIN_FAMILIES["memcpy/memset"]}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def trained_like_(module, gen):
    """Seeded random weights with trained-like statistics (He-scaled trunk
    and deconv kernels, BN near identity), so activations are not
    degenerate as they are under the reference's N(0, 0.001) init. The
    head keeps that init; main() rescales it so heatmaps span [-1, 1], the
    range the aggregation's input scale (1.2 / 127) assumes."""
    import torch

    with torch.no_grad():
        for name, t in module.state_dict().items():
            if (name.endswith("num_batches_tracked") or name.startswith("aggre_layer")
                    or name.endswith("final_layer.weight")):
                continue
            r = torch.randn(t.shape, generator=gen)
            if t.dim() == 4:
                fan_in = t[0].numel() if "deconv" not in name else t.shape[0] * 4
                t.copy_(r * (2.0 / fan_in) ** 0.5)
            elif name.endswith("running_var"):
                t.copy_(1.0 + 0.05 * r.abs())
            elif name.endswith("weight"):  # BN scale
                t.copy_(1.0 + 0.1 * r)
            else:  # BN shift, running mean, conv bias
                t.copy_(0.1 * r)


@contextmanager
def capture_first_calls(targets, every=False):
    """Record the arguments of the first call of each (module, name) while
    the block runs (``every``: of all its calls, as a list); the calls still
    go through the real function."""
    seen, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(*a, _fn=fn, _name=name, **kw):
            if every:
                seen.setdefault(_name, []).append((a, kw))
            else:
                seen.setdefault(_name, (a, kw))
            return _fn(*a, **kw)
        # a kernel wrapper counts its launches on its module-level name, which
        # points here meanwhile: those launches are not the main path's
        wrapper.launches = 0
        setattr(mod, name, wrapper)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tail2_instance(jt: int, epilogue: str, design: str, store: str) -> str:
    """A ``tail2_kernel`` instance's name as the profile shows it, spaces
    dropped: its template arguments in csrc/tail2.cu's order."""
    from posetpu_torch.ops import phase_tail as pt

    return (f"tail2_kernel<{jt},{pt.EPILOGUES.index(epilogue)},{pt.DESIGNS.index(design)},"
            f"{pt.STORES.index(store)}>")



def profile_request(fn, families=None) -> dict:
    """Device time of one call of ``fn`` by kernel family (the serving
    paths' unless ``families`` {name: substrings} is given), from
    torch.profiler's CUDA activity, and the device's idle share of the
    call's wall time (host clock, ending in a synchronize)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(dev, "torch.profiler recorded no device activity")
    inst = lambda epi, cases: tuple(tail2_instance(jt, epi, d, st) for d, jt, st in cases)
    families = families or {"deconv0 (B2)": inst("relu_phase", [("stream", 0, "phase_major")]),
                "deconv1 + deconv2 + head (B1)": inst("relu", [
                    ("halo", 0, "interleaved"), ("halo", 2, "head_packed2"),
                    ("halo", 4, "head_packed2")]),
                "subpixel deconv + head (B9a, B9b)": inst("folded", [
                    ("stream", 0, "interleaved"), ("halo", 0, "interleaved"),
                    ("halo", 2, "head_row_major"), ("halo", 4, "head_row_major")]),
                "per-pair deconv0 (B6)": inst("relu_phase", [("stream", 0, "n_minor")]),
                "one-level deconv + head (B5)": inst("relu", [("halo", 2, "head_packed1"),
                                                              ("halo", 4, "head_packed1")]),
                "aggregation (B3, B4, their quantize)": ("aggregation_kernel",
                                                         "aggregation_w4_kernel",
                                                         "quantize_kernel"),
                "decode (B7)": ("decode_kernel",),
                "bottleneck (B8a, B8b)": ("bottleneck_rows_kernel", "bottleneck_v2_kernel"),
                "f32 convolutions and GEMMs (float path)": (
                    "cudnn", "conv", "sgemm", "gemv", "f32f32", "fft",
                    "pointwise_mult_and_sum"),
                "int8 GEMM (trunk, torch._int_mm)": ("gemm", "Gemm", "cutlass", "xmma"),
                "memcpy/memset": ("Memcpy", "Memset")}
    by_family, by_name, hand = {}, {}, {}
    spans = []
    for e in dev:
        us = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.replace(" ", "")
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)),
                   "other PyTorch kernels (elementwise, reductions, im2col)")
        by_family[fam] = by_family.get(fam, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if "posetpu::" in e.name:  # the hand kernels, launches by name and instance
            short = e.name.split("posetpu::")[1].split("(")[0].replace(" ", "")
            hand[short] = hand.get(short, 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3, "device_events": len(dev),
            "idle_share": 1.0 - busy / wall_us,
            "by_family_ms": {k: v / 1e3 for k, v in sorted(by_family.items(),
                                                           key=lambda kv: -kv[1])},
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
            "hand_kernel_launches": hand}


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        else:
            total += t.numel() * t.element_size()
    return total


def bound(ops: float, nbytes_: float, peak_ops: float = PEAK_INT8_OPS):
    """(least ms, "operations" | "bytes") at the published peaks; ``ops``
    counts a multiply-accumulate as 2."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_gemms(x4, wk, z=None, wh=None):
    """The library yardstick of a phase-form deconv (+ head) on x4 [N, H, W,
    Cin] int8 with K-minor weights wk [4 phase, 4 tap, Cout, Cin]: per phase
    one ``torch._int_mm`` [N H W, 4 Cin] x [4 Cin, Cout] on operands gathered
    beforehand (the four shifted taps side by side, zeros outside the image;
    not timed), and for a head wh [J, Cout] one more on its int8 input ``z``
    [..., Cout]: the GEMMs alone, as B3's yardstick."""
    import torch
    import torch.nn.functional as F

    n, h, w, cin = x4.shape
    xp = F.pad(x4, (0, 0, 1, 1, 1, 1))
    a_ops, b_ops = [], []
    for g in range(4):
        a, b = g >> 1, g & 1
        taps = [xp[:, (t >> 1) + a:(t >> 1) + a + h, (t & 1) + b:(t & 1) + b + w].reshape(-1, cin)
                for t in range(4)]
        a_ops.append(torch.cat(taps, dim=1).contiguous())
        b_ops.append(wk[g].permute(0, 2, 1).reshape(4 * cin, -1).contiguous())
    calls = [lambda g=g: torch._int_mm(a_ops[g], b_ops[g]) for g in range(4)]
    if z is not None:
        zz = z.reshape(-1, z.shape[-1]).contiguous()
        # cuBLASLt's int8 GEMM refuses some shapes: N padded to 32, as ops/int_mm
        wk_h = F.pad(wh.t(), (0, -wh.shape[0] % 32)).contiguous()
        calls.append(lambda: torch._int_mm(zz, wk_h))
    return lambda: [c() for c in calls]


def train_batch(groups: int, size: int, hm: int, joints: int, device, seed: int) -> dict:
    """A synthetic supervised batch as bench.py's ``_build_train`` makes it,
    on ``device`` from ``seed``: normal images [G, 4, size, size, 3],
    uniform targets [G, 4, hm, hm, J], unit weights, every group h36m,
    center 500 and scale 2.5, and the camera ring's F bank."""
    import torch

    from posetpu_torch.data.synthetic import make_camera_ring
    from posetpu_torch.geometry.fundamental import bank_to_batch, build_fundamental_bank

    gen = torch.Generator(device=device).manual_seed(seed)
    bank = build_fundamental_bank({0: make_camera_ring()})
    return {"images": torch.randn(groups, 4, size, size, 3, generator=gen, device=device),
            "target": torch.rand(groups, 4, hm, hm, joints, generator=gen, device=device),
            "weight": torch.ones(groups, 4, joints, device=device),
            "is_h36m": torch.ones(groups, device=device),
            "center": torch.full((groups, 4, 2), 500.0, device=device),
            "scale": torch.full((groups, 4, 2), 2.5, device=device),
            "fmats": bank_to_batch(bank, [0] * groups, device=device)}


def train_config(num_layers: int, size: int, hm: int):
    """bench.py's ``_build_train`` configuration at a depth and size: the
    bank, MSE + consistency + fundamental loss, Adam at TRAIN.LR (1e-3)."""
    from posetpu_torch.config import default_config

    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = num_layers
    cfg.NETWORK.IMAGE_SIZE = np.array([size, size])
    cfg.NETWORK.HEATMAP_SIZE = np.array([hm, hm])
    cfg.NETWORK.AGGRE = True
    cfg.LOSS.USE_CONSISTENT_LOSS = True
    cfg.LOSS.USE_FUNDAMENTAL_LOSS = True
    return cfg


def gan_config(num_layers: int, size: int, hm: int):
    """The adversarial configuration of path 8: the LOSS section of
    experiments/mixed/resnet50/pseudo_label/
    256_fund5_local_mi_joint_nofusion_resume_pseudo.yaml (the joint-specific
    local MI, JSD, 400 positives, 15 negatives each, weight 0.001; the
    fundamental loss at 5), with the other four adversarial losses on at
    their own files' measures and weights: heatmap MI (JSD, 0.01) from
    256_fund5_heatmap_..., the domain GAN (0.01) from 256_fund5_domain_...,
    view and joints MI (NCE, 1) from 256_nofusion_viewmi_jointsmi.yaml. No
    bank and no fused output (NETWORK.AGGRE, TEST.FUSE_OUTPUT false, as in
    every adversarial config there); Adam at 1e-3 for the base and the
    critics."""
    from posetpu_torch.config import default_config

    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = num_layers
    cfg.NETWORK.IMAGE_SIZE = np.array([size, size])
    cfg.NETWORK.HEATMAP_SIZE = np.array([hm, hm])
    cfg.NETWORK.AGGRE = False
    cfg.TEST.FUSE_OUTPUT = False
    loss = dict(CONSISTENT_LOSS_WEIGHT=0.01, FUNDAMENTAL_LOSS_WEIGHT=5, LOCAL_MI_LOSS_WEIGHT=0.001,
                MI_MEASURE="JSD", MI_NEG_POS_RATIO=15, MI_POSITIVE_NUM=400, MSE_LOSS_WEIGHT=1,
                SPECIFIC="joint", USE_FUNDAMENTAL_LOSS=True, USE_LOCAL_MI_LOSS=True,
                USE_LOW_FEATURES_PREPROCESS=False, USE_TARGET_WEIGHT=True,
                USE_HEATMAP_MI_LOSS=True, HEATMAP_MI_MEASURE="JSD", HEATMAP_MI_LOSS_WEIGHT=0.01,
                USE_DOMAIN_TRANSFER_LOSS=True, DOMAIN_LOSS_WEIGHT=0.01,
                USE_VIEW_MI_LOSS=True, VIEW_MI_MEASURE="NCE",
                USE_JOINTS_MI_LOSS=True, JOINTS_MI_MEASURE="NCE")
    for k, v in loss.items():
        setattr(cfg.LOSS, k, v)
    return cfg


def gan_batch(groups: int, size: int, hm: int, joints: int, device, seed: int) -> dict:
    """:func:`train_batch` with the MI samplers' inputs: crop joints uniform
    over the image, 80 % visible, the targets rendered from them, and every
    other group h36m (the rest mpii: the domain GAN's two labels)."""
    import torch

    from posetpu_torch.ops.heatmap import render_gaussian_heatmaps

    b = train_batch(groups, size, hm, joints, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    jc = torch.rand(groups, 4, joints, 2, generator=gen, device=device) * size
    vis = (torch.rand(groups, 4, joints, generator=gen, device=device) > 0.2).float()
    target, weight = render_gaussian_heatmaps(jc, vis, (hm, hm), (size, size), 2.0)
    b.update(joints_crop=jc, joints_vis=vis, target=target.movedim(-3, -1).contiguous(),
             weight=weight, is_h36m=(torch.arange(groups, device=device) % 2 == 0).float())
    return b


def gan_card_vs_cpu(cfg, batch: dict, parity: int, card, seed: int) -> tuple[str, list]:
    """One f32 adversarial step of each model from the same weights and
    draws (the CPU's) on ``card`` (TF32 off) and on the CPU, and two more on
    the CPU with the images scaled by 1 +- 1e-7: the larger distance of
    those from the CPU's step is the yardstick of how far rounding alone
    moves a gradient. The loss within rtol 1e-4; per model, the gradients'
    cosine over all leaves > 0.9999 and each leaf within 2e-2 relative L2
    (path 7's bounds), or within three times the yardstick where that is
    larger; a leaf whose gradient is rounding noise (below 1e-5 of the
    model's largest leaf norm) counts in the cosine only. Returns (a summary
    line, the failures).

    The base has :func:`trained_like_` weights and the batch should hold 3
    or more groups. Under the reference's N(0, 0.001) init the heatmaps are
    near flat and the groups' soft-argmax joints agree to rounding; and over
    2 samples a BatchNorm's output is +-1 whatever its input, so the view and
    joints critics' first layers (and, at parity 1, the base through their
    generator terms) get a gradient that is zero but for rounding, which
    BatchNorm's 1 / sigma then scales up: noise held against noise."""
    import torch

    from posetpu_torch.core.mi import sample_draws
    from posetpu_torch.models import quant
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.gan import init_discriminator_states, make_adversarial_train_step
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state

    draws = sample_draws(batch, cfg, parity, torch.Generator().manual_seed(seed))
    cases = [("card", card, batch), ("cpu", torch.device("cpu"), batch)] + [
        (f"nudge {f}", torch.device("cpu"), dict(batch, images=batch["images"] * f))
        for f in (1 + 1e-7, 1 - 1e-7)]
    runs = {}
    for label, device, b in cases:
        gen = torch.Generator().manual_seed(seed)
        net, critics = get_multiview_pose_net(cfg, gen), build_discriminators(cfg, gen)
        trained_like_(net, gen)
        tx = make_optimizer(cfg, steps_per_epoch=1000)
        tx_d = {n: make_optimizer(cfg, 1000, discriminator=True) for n in critics}
        states = {"base_model": init_train_state(net, tx, device=device),
                  **init_discriminator_states(critics, tx_d, device=device)}
        step = make_adversarial_train_step(net, critics, cfg, tx, tx_d, device=device)
        with quant._full_fp32():
            _, m = step(states, b, parity, draws=draws)
        runs[label] = (float(m["loss"]), {
            n: {k: p.grad.double().cpu() for k, p in st.params.named_parameters()
                if p.grad is not None} for n, st in states.items()})

    def distance(a, b):
        """(1 - cosine over the leaves, {leaf: relative L2}) of b from a."""
        va = torch.cat([g.flatten() for g in a.values()])
        vb = torch.cat([b[k].flatten() for k in a])
        top = max(float(g.norm()) for g in a.values())
        rel = {k: float((b[k] - g).norm() / g.norm()) for k, g in a.items()
               if float(g.norm()) > 1e-5 * top}
        return 1.0 - float(torch.nn.functional.cosine_similarity(va, vb, dim=0)), rel

    (l_card, g_card), (l_cpu, g_cpu) = runs["card"], runs["cpu"]
    nudged = [runs[label][1] for label, _, _ in cases[2:]]
    lerr = abs(l_card - l_cpu) / abs(l_cpu)
    failures = [f"loss {l_card} vs {l_cpu}"] if lerr > 1e-4 else []
    summary = {}
    for n, grads in g_cpu.items():
        if set(grads) != set(g_card[n]):
            failures.append(f"{n}: gradients present on one side only")
            continue
        if not grads:  # a critic with no loss at this parity
            summary[n] = "no gradient"
            continue
        c_card, rel_card = distance(grads, g_card[n])
        yard = [distance(grads, g[n]) for g in nudged]
        c_yard = max(c for c, _ in yard)
        rel_yard = {k: max(r[k] for _, r in yard) for k in rel_card}
        if c_card > max(1e-4, 3 * c_yard):
            failures.append(f"{n}: gradient cosine {1 - c_card} (yardstick {1 - c_yard})")
        for k, r in rel_card.items():
            if r > max(2e-2, 3 * rel_yard[k]):
                failures.append(f"{n}.{k}: relative L2 {r} (yardstick {rel_yard[k]})")
        worst = max(rel_card, key=rel_card.get)
        summary[n] = (f"cosine {1 - c_card:.8f} (yardstick {1 - c_yard:.8f}), worst relative "
                      f"L2 {rel_card[worst]:.2e} ({worst}; yardstick {rel_yard[worst]:.2e})")
    return (f"loss {l_card} vs {l_cpu} (relative {lerr:.2e}); {summary}", failures)


def crop_boxes(pix):
    """H36M-style crops of [..., J, 2] pixels: the centre and the scale (box
    side / 200) of the joints' box with a 25 % margin, square."""
    lo, hi = pix.amin(dim=-2), pix.amax(dim=-2)
    side = (hi - lo).amax(dim=-1, keepdim=True) * 1.25
    return (lo + hi) / 2.0, (side / 200.0).expand(lo.shape).contiguous()


def render_views(pix, center, scale, shift=None, conf=None):
    """64x64 maps (sigma 2) of [..., J, 2] pixels in their 256x256 crops;
    ``shift`` [..., J, 2] moves a peak (crop pixels), ``conf`` [..., J]
    scales a map."""
    import torch

    from posetpu_torch.ops.affine import affine_transform_points, get_affine_transform
    from posetpu_torch.ops.heatmap import render_gaussian_heatmaps

    crop = affine_transform_points(pix, get_affine_transform(center, scale, 0.0, (256, 256)))
    if shift is not None:
        crop = crop + shift
    hm, _ = render_gaussian_heatmaps(crop, torch.ones(crop.shape[:-1], device=crop.device),
                                     (64, 64), (256, 256), 2)
    return hm if conf is None else hm * conf[..., None, None]


def path9(dev, reset_counts, read_counts) -> tuple[dict, dict]:
    """Path 9 at full width: G9 four-view groups of skeletons seen by the
    synthetic rig (1000x1000, distortion), cropped as the H36M annotation
    does, rendered to 64x64 maps in chunks, each map scaled by a seeded
    confidence, a share of the group-joints with one view's peak planted far
    off; decoded by ``final_preds`` (B7); ``mint_pseudo_labels`` (the sweep
    alone where h5py is absent); ``triangulate_poses`` on the GT and the
    decoded 2D; ``rpsm`` at test_rpsm.yaml's PICT_STRUCT on RPSM_GROUPS
    groups rendered in H36M's projection. Returns the line's numbers and
    the inputs of the card-vs-CPU checks."""
    import shutil

    import torch

    from posetpu_torch.config import default_config
    from posetpu_torch.core.inference import final_preds
    from posetpu_torch.data.synthetic import make_camera_ring, make_skeleton_poses, tile_cameras
    from posetpu_torch.geometry.cameras import project_points, project_pose
    from posetpu_torch.geometry.pictorial import limb_lengths_from_pose, rpsm
    from posetpu_torch.geometry.triangulate import (ransac_filter, reproject_poses,
                                                    triangulate_poses)
    from posetpu_torch.ops.affine import affine_transform_points, get_affine_transform
    from posetpu_torch.pseudo.labeler import mint_pseudo_labels, sweep_pseudo_labels

    t_start = time.perf_counter()
    n = G9 * VIEWS
    cams = tile_cameras(make_camera_ring(device=dev), G9)
    cams_flat = cams.map(lambda x: x.reshape((n,) + x.shape[2:]))
    poses = torch.from_numpy(make_skeleton_poses(G9, seed=9)).to(dev)  # [G, J, 3] mm
    pix = project_points(poses[:, None], cams)  # [G, V, J, 2], OpenCV's convention
    center, scale = crop_boxes(pix)
    gen = torch.Generator(device=dev).manual_seed(9)
    conf = torch.rand(G9, VIEWS, 16, generator=gen, device=dev) * 0.6 + 0.4
    # outliers: one view of OUTLIER_SHARE of the group-joints, its peak moved
    # 40-80 crop pixels (~75-150 image pixels) towards the crop's middle,
    # give or take 45 degrees, so that it stays on the map
    planted = torch.zeros(G9, VIEWS, 16, dtype=torch.bool, device=dev)
    g_, j_ = torch.nonzero(torch.rand(G9, 16, generator=gen, device=dev) < OUTLIER_SHARE,
                           as_tuple=True)
    planted[g_, torch.randint(0, VIEWS, g_.shape, generator=gen, device=dev), j_] = True
    ang = torch.rand(G9, VIEWS, 16, generator=gen, device=dev) * (torch.pi / 2) - torch.pi / 4
    dist = torch.rand(G9, VIEWS, 16, generator=gen, device=dev) * 40 + 40
    setup_s = time.perf_counter() - t_start

    def shift_of(s):
        crop = affine_transform_points(pix[s], get_affine_transform(center[s], scale[s], 0.0,
                                                                    (256, 256)))
        to_mid = 128.0 - crop
        base = torch.atan2(to_mid[..., 1], to_mid[..., 0]) + ang[s]
        move = torch.stack([torch.cos(base), torch.sin(base)], dim=-1) * dist[s][..., None]
        return move * planted[s][..., None]

    have_h5 = True
    try:
        import h5py  # noqa: F401
    except ImportError:
        have_h5 = False
    gt2d = pix.reshape(n, 16, 2).cpu().numpy()
    headsizes = (scale.amax(dim=-1) * 200 / 10.0).reshape(n, 1).cpu().numpy()
    kw = dict(thresholds=THRESHOLDS, if_ransac=True, num_inliers=3, reproj_thre=10.0,
              use_reproj=True, gt2d=gt2d, headsizes=headsizes)
    out_dir = ROOT / "build" / "path9"

    # ---- the main path: decode (B7), mint, triangulate, RPSM
    reset_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    preds, maxvals = [], []
    step = RENDER_CHUNK // VIEWS
    for a in range(0, G9, step):
        s = slice(a, a + step)
        hm = render_views(pix[s], center[s], scale[s], shift_of(s), conf[s])
        p, m = final_preds(hm, center[s], scale[s])
        preds.append(p)
        maxvals.append(m)
    del hm
    preds, maxvals = torch.cat(preds), torch.cat(maxvals)  # [G, V, J, 2], [G, V, J]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t_path
    pred2d = preds.reshape(n, 16, 2).cpu().numpy()
    confidence = maxvals.reshape(n, 16).cpu().numpy()

    t = time.perf_counter()
    if have_h5:
        summary = mint_pseudo_labels(pred2d, confidence, cams_flat, str(out_dir),
                                     log=lambda *_: None, device=dev, **kw)
        entries = summary["entries"]
        written = sorted(p.name for p in out_dir.iterdir())
        check(len(written) == 2 * len(THRESHOLDS) + 2 and summary["choose"]() is not None,
              f"{PATH9}: the mint wrote {written}")
        shutil.rmtree(out_dir)
    else:
        entries = [st["entry"] for st in
                   sweep_pseudo_labels(pred2d, confidence, cams_flat, device=dev, **kw)]
    mint_s = time.perf_counter() - t

    t = time.perf_counter()
    tri_gt = triangulate_poses(pix.reshape(n, 16, 2), cams_flat)
    tri_dec = triangulate_poses(preds.reshape(n, 16, 2), cams_flat)
    mpjpe_gt = float(torch.linalg.vector_norm(tri_gt - poses, dim=-1).mean())
    mpjpe_dec = float(torch.linalg.vector_norm(tri_dec - poses, dim=-1).mean())
    torch.cuda.synchronize()
    tri_s = time.perf_counter() - t

    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE = np.array([256, 256])
    cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64])
    ps = cfg.PICT_STRUCT  # experiments/multiview_h36m/test/test_rpsm.yaml
    ps.FIRST_NBINS, ps.RECUR_NBINS, ps.RECUR_DEPTH = 16, 2, 10
    ps.GRID_SIZE, ps.LIMB_LENGTH_TOLERANCE = 2000, 150
    r = slice(0, RPSM_GROUPS)
    pix_r = project_pose(poses[r, None], cams.map(lambda x: x[r]))  # H36M's convention
    center_r, scale_r = crop_boxes(pix_r)
    # the template limbs: each skeleton's lengths, averaged (the mean pose of
    # skeletons turned every way would shorten every limb)
    limbs = limb_lengths_from_pose(poses[r]).mean(0)
    rpsm_args = (render_views(pix_r, center_r, scale_r), cams.map(lambda x: x[r]), center_r,
                 scale_r, poses[r, 6].contiguous(), limbs, cfg)
    rpsm_ms, peaks = [], []
    for _ in range(2):  # the second run is the line's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out_r = rpsm(*rpsm_args)
        ev[1].record()
        ev[1].synchronize()
        rpsm_ms.append(ev[0].elapsed_time(ev[1]))
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
    err_r = torch.linalg.vector_norm(out_r - poses[r], dim=-1)
    counts = read_counts()
    cfg0 = copy.deepcopy(cfg)  # the first level alone: what the recursion adds
    cfg0.PICT_STRUCT.RECUR_DEPTH = 0
    first_level_ms = cuda_ms(lambda: rpsm(*rpsm_args[:-1], cfg0), warmup=1, reps=3)
    path_s = time.perf_counter() - t_path

    # RANSAC and the reprojection per threshold over all groups (CUDA events),
    # and what RANSAC keeps of the planted outliers and of the clean views
    per_thre = []
    for thre in THRESHOLDS:
        vis = (maxvals > thre).float()
        ransac = lambda: ransac_filter(preds, cams, vis, 10.0, 3)
        kept = ransac()
        reproj = lambda: reproject_poses(preds, cams, kept)
        seen = vis > 0
        per_thre.append({
            "thre": thre, "ransac_ms": cuda_ms(ransac, warmup=1, reps=5),
            "reproj_ms": cuda_ms(reproj, warmup=1, reps=5),
            "outliers_dropped": float((kept[planted & seen] == 0).float().mean()),
            "clean_kept": float((kept[~planted & seen] == 1).float().mean())})
    # where the time goes: RANSAC at the first threshold, the reprojection of
    # its inliers, and the 64 groups' RPSM
    vis = (maxvals > THRESHOLDS[0]).float()
    kept = ransac_filter(preds, cams, vis, 10.0, 3)
    profiles = {name: profile_request(fn, PATH9_FAMILIES) for name, fn in (
        ("ransac", lambda: ransac_filter(preds, cams, vis, 10.0, 3)),
        ("reprojection", lambda: reproject_poses(preds, cams, kept)),
        ("rpsm", lambda: rpsm(*rpsm_args)))}
    check(mpjpe_gt < 1.0, f"{PATH9}: GT triangulation MPJPE {mpjpe_gt} mm")
    check(bool(torch.isfinite(tri_dec).all()) and mpjpe_dec < 100.0,
          f"{PATH9}: decoded triangulation MPJPE {mpjpe_dec} mm")
    check(float(err_r.mean()) < 60.0 and float(err_r.max()) < 150.0,
          f"{PATH9}: RPSM MPJPE {float(err_r.mean())} mm, max {float(err_r.max())}")
    check(per_thre[0]["outliers_dropped"] >= MIN_OUTLIERS_DROPPED
          and per_thre[0]["clean_kept"] >= MIN_CLEAN_KEPT, f"{PATH9}: RANSAC {per_thre[0]}")
    check(all(0.0 < e["vis"] < 1.0 and 0.5 < e["pckh"] <= 1.0 for e in entries),
          f"{PATH9}: entries {entries}")
    line = {"groups": G9, "images": n, "h5py": have_h5,
            "mint": "mint_pseudo_labels" if have_h5 else "sweep_pseudo_labels (no h5py)",
            "entries": [{k: e[k] for k in ("tag", "pckh", "vis")} for e in entries],
            "per_threshold": per_thre, "mpjpe_gt_mm": mpjpe_gt, "mpjpe_decoded_mm": mpjpe_dec,
            "rpsm_groups": RPSM_GROUPS, "rpsm_mpjpe_mm": float(err_r.mean()),
            "rpsm_max_mm": float(err_r.max()), "rpsm_ms": rpsm_ms,
            "rpsm_ms_a_group": rpsm_ms[-1] / RPSM_GROUPS, "rpsm_peak_gib": peaks,
            "rpsm_first_level_ms": first_level_ms,
            "seconds": {"setup": setup_s, "render_decode": decode_s, "mint": mint_s,
                        "triangulate": tri_s, "path": path_s},
            "launches": {k: v for k, v in counts.items() if v}, "profiles": profiles}
    c = slice(0, CHECK_GROUPS)
    vis06 = (maxvals[c] > THRESHOLDS[0]).float()
    hm_r, cams_r, _, _, roots_r, limbs_r, _ = rpsm_args
    s0 = slice(0, step)
    checks = {"preds": preds[c], "cams": cams.map(lambda x: x[c]), "vis": vis06,
              "rpsm_one": (hm_r[:1], cams_r.map(lambda x: x[:1]), center_r[:1], scale_r[:1],
                           roots_r[:1], limbs_r, cfg),
              # the main path's first chunk again, for phase 4 to take B7's input
              "decode_first_chunk": lambda: final_preds(
                  render_views(pix[s0], center[s0], scale[s0], shift_of(s0), conf[s0]),
                  center[s0], scale[s0])}
    return line, checks


def path9_card_vs_cpu(checks) -> str:
    """RANSAC's res_vis equal, the reprojection (of RANSAC's inliers, as the
    mint feeds it) within 1e-3 px, and one group's RPSM pose within 1 mm a
    joint, card against CPU on the same inputs."""
    import torch

    from posetpu_torch.geometry.pictorial import rpsm
    from posetpu_torch.geometry.triangulate import ransac_filter, reproject_poses

    cpu = lambda t: t.map(lambda x: x.cpu()) if hasattr(t, "map") else (
        t.cpu() if torch.is_tensor(t) else t)
    p, cams, vis = checks["preds"], checks["cams"], checks["vis"]
    kept = ransac_filter(p, cams, vis, 10.0, 3)
    kept_cpu = ransac_filter(cpu(p), cpu(cams), cpu(vis), 10.0, 3)
    check(torch.equal(kept.cpu(), kept_cpu),
          f"card vs CPU, {PATH9}: RANSAC differs on {int((kept.cpu() != kept_cpu).sum())} views")
    proj, rv = reproject_poses(p, cams, kept)
    proj_cpu, rv_cpu = reproject_poses(cpu(p), cpu(cams), kept_cpu)
    perr = float((proj.cpu() - proj_cpu).abs().max())
    check(torch.equal(rv.cpu(), rv_cpu) and perr <= 1e-3,
          f"card vs CPU, {PATH9}: reprojection differs by {perr} px")
    one = checks["rpsm_one"]
    pose = rpsm(*one)
    t = time.perf_counter()
    pose_cpu = rpsm(*[cpu(a) for a in one])
    jerr = float(torch.linalg.vector_norm(pose.cpu() - pose_cpu, dim=-1).max())
    check(jerr <= 1.0, f"card vs CPU, {PATH9}: RPSM pose {jerr} mm apart")
    return (f"card vs CPU, {PATH9} on {p.shape[0]} groups: RANSAC's res_vis equal "
            f"({float(kept.mean()):.4f} kept), reprojection max abs diff {perr} px; RPSM on "
            f"one group (16 bins, depth 10): {jerr} mm a joint at most (CPU run "
            f"{time.perf_counter() - t:.1f} s)")


class _Held:
    """The next ``n`` batches of a loader's running iterator, as a loader of
    their own (its epoch already set)."""

    def __init__(self, it, n: int):
        self.it, self.n = it, n

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            yield next(self.it)


def path10_step(preset: str, tmp: str, dev, reset_counts, read_counts,
                resume_from: str = "") -> tuple[dict, dict]:
    """One epoch of ``python -m posetpu_torch.cli.train --cfg <preset>
    --epochs 1`` on the fixture under ``tmp`` as path 10's main path (the
    CLI's setup, then its epoch loop: train, validate, checkpoints; the
    validate H5 dump only where h5py is present), then its measurements and
    checks. ``resume_from``: the final_state to warm-start from (the
    preset's RESUME_PATH, under ``tmp``). Returns (its line, what phase 4
    takes: B7's input on one validate batch)."""
    import torch

    from posetpu_torch.cli import train as train_cli
    from posetpu_torch.cli.common import build_model, load_cfg, load_model_variables
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.prepare import make_prepare_fn
    from posetpu_torch.models import quant
    from posetpu_torch.ops import decode as dec
    from posetpu_torch.train import loop
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_eval_step, make_train_step
    from posetpu_torch.utils.profiling import StepTimer

    name = Path(preset).stem
    args = train_cli.parse_args(["--cfg", str(ROOT / preset), "--modelDir", f"{tmp}/output",
                                 "--logDir", f"{tmp}/log", "--dataDir", tmp, "--epochs", "1"])
    cfg = load_cfg(args)
    if resume_from:
        check(cfg.TRAIN.RESUME and os.path.relpath(resume_from, tmp) == cfg.TRAIN.RESUME_PATH,
              f"{PATH10} {name}: the preset resumes from {cfg.TRAIN.RESUME_PATH}")
        cfg.TRAIN.RESUME_PATH = resume_from
    t0 = time.perf_counter()
    tr = train_cli.setup(cfg, args, device=dev)
    setup_s = time.perf_counter() - t0
    bs = int(cfg.TRAIN.BATCH_SIZE)
    line = {"preset": preset, "setup_s": setup_s, "groups_a_batch": bs,
            "train_groups": len(tr.train_ds), "validate_groups": len(tr.test_ds),
            "loader_threads": tr.train_loader.num_threads}
    if resume_from:  # the warm start loaded step 1's weights, bit for bit
        saved = load_model_variables(resume_from)
        now = tr.base.params.state_dict()
        check(all(torch.equal(now[k].cpu(), v) for part in saved.values()
                  for k, v in part.items()), f"{PATH10} {name}: not step 1's weights")

    # ---- the main path: the CLI's epoch loop, each phase timed
    step = tr.train_step
    losses, dispatch = [], []

    def recording(st, b):
        t = time.perf_counter()
        st, m = step(st, b)
        dispatch.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"])
        return st, m

    gc_ms = {0: 0.0, 1: 0.0, 2: 0.0}
    gc_start = {}

    def on_gc(phase, info):  # the interpreter's collections, by generation
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            gc_ms[info["generation"]] += (time.perf_counter() - gc_start.pop("t")) * 1e3

    phases = {}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[key] = phases.get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    have_h5 = True
    try:
        import h5py  # noqa: F401
    except ImportError:
        have_h5 = False
    line["branch"] = ("setup + train_epochs with the H5 dump" if have_h5 else
                      "h5py absent: setup + train_epochs with validate(output_dir=None)")
    tr.train_step, tr.timer = recording, StepTimer()
    orig = loop.train_epoch, loop.validate
    loop.train_epoch, loop.validate = timed("train", orig[0]), timed("validate", orig[1])
    tr.ckpt.save_epoch = timed("save_epoch", tr.ckpt.save_epoch)
    tr.ckpt.save_final = timed("save_final", tr.ckpt.save_final)
    line["python_objects"] = len(gc.get_objects())
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        line["perf"] = train_cli.train_epochs(tr, tr.output_dir if have_h5 else None)
    finally:
        gc.callbacks.remove(on_gc)
        loop.train_epoch, loop.validate = orig
        del tr.ckpt.save_epoch, tr.ckpt.save_final
        tr.train_step = step
        tr.writer.close()
    torch.cuda.synchronize()
    line["main_path_s"] = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    line["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    n_val = len(tr.test_loader)
    check(counts == {"decode_heatmaps_kernel": n_val},
          f"{PATH10} {name}: hand kernel launches {counts}, {n_val} validate batches")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"{PATH10} {name}: non-finite loss")
    steps = len(tr.train_loader)
    check(len(losses) == steps == tr.base.step, f"{PATH10} {name}: {len(losses)} steps")
    check(os.path.exists(os.path.join(tr.output_dir, "final_state.pt")),
          f"{PATH10} {name}: no final_state")
    data_ms = [t * 1e3 for t in tr.timer.data_times]
    line.update({
        "steps": steps, "b7_launches": n_val, "validate_batches": n_val,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "loop_groups_per_s": steps * bs / phases["train"],
        "loop_s": phases["train"], "validate_s": phases["validate"],
        "validate_groups_per_s": len(tr.test_ds) / phases["validate"],
        "save_epoch_ms": phases["save_epoch"] * 1e3, "save_final_ms": phases["save_final"] * 1e3,
        "data_ms_median": statistics.median(data_ms), "data_ms_mean": statistics.mean(data_ms),
        "data_ms_first": data_ms[0], "data_ms_max": max(data_ms),
        "dispatch_ms_median": statistics.median(dispatch), "dispatch_ms_max": max(dispatch),
        "gc_ms_by_generation": gc_ms})

    # ---- the loader alone (no prefetch: one batch's host time), its batches
    # held for the step alone; one record's host time by source
    ds, threads = tr.train_ds, tr.train_loader.num_threads
    loader = GroupLoader(ds, bs, prefetch=0, num_threads=threads)
    it = iter(loader)
    next(it)
    held, times = [], []
    for _ in range(HELD_BATCHES):
        t = time.perf_counter()
        held.append(next(it))
        times.append((time.perf_counter() - t) * 1e3)
    it.close()
    line["loader_ms_a_batch_alone"] = statistics.median(times)
    rs = np.random.RandomState(0)
    by_source = {}
    for i in range(0, len(ds.db), max(len(ds.db) // 64, 1)):
        t = time.perf_counter()
        ds.load_record(i, rs)
        by_source.setdefault(ds.db[i]["source"], []).append((time.perf_counter() - t) * 1e3)
    line["host_ms_an_image"] = {k: statistics.median(v) for k, v in by_source.items()}

    # two passes over one epoch seed, and prefetch 0 against 2: equal bytes
    def first_batches(prefetch):
        lo = GroupLoader(ds, bs, prefetch=prefetch, num_threads=threads)
        lo.set_epoch(0)
        it = iter(lo)
        out = [next(it) for _ in range(3)]
        it.close()
        return out

    a, b, c = first_batches(0), first_batches(0), first_batches(2)
    check(all(x.keys() == y.keys() and all(x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
                                           for k in x) for p in (b, c) for x, y in zip(a, p)),
          f"{PATH10} {name}: the loader is not deterministic")

    # prepare on the card against the CPU's on one batch
    host = a[0]
    got, ref = tr.prepare(host), make_prepare_fn(cfg, "cpu")(host)
    ierr = float((got["images"].cpu() - ref["images"]).abs().max())
    terr = float((got["target"].cpu() - ref["target"]).abs().max())
    check(ierr <= 2 * float(np.spacing(np.float32(2.7))) and terr <= 1e-6
          and all(torch.equal(got[k].cpu(), ref[k]) for k in ref if k not in ("images", "target")),
          f"{PATH10} {name}: prepare, card vs CPU: images {ierr}, targets {terr}")
    line["prepare_card_vs_cpu"] = {"images_max_abs": ierr, "target_max_abs": terr}

    # the step alone on the held batches, already on the card
    dev_batches = []
    for hb in held:
        db = tr.prepare(hb)
        dev_batches.append(tr.extra(hb, db) if tr.extra is not None else db)
    state = tr.state
    for db in dev_batches[:2]:
        state, _ = step(state, db)
    events = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for db in dev_batches:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, db)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    gps = sorted(bs * 1e3 / e0.elapsed_time(e1) for e0, e1 in events)
    line["step_alone_groups_per_s"] = {"median": statistics.median(gps), "min": gps[0],
                                       "max": gps[-1], "host_clock": bs * len(events) / wall}
    tr.state = state
    del dev_batches

    # PROFILED_STEPS steps of the loop (prefetch running) under the profiler
    lo = GroupLoader(ds, bs, num_threads=threads)
    lo.set_epoch(1)
    it = iter(lo)
    next(it)
    time.sleep(0.5)  # its prefetch queue fills, as in a running epoch
    prof = profile_request(lambda: loop.train_epoch(cfg, _Held(it, PROFILED_STEPS), tr.prepare,
                                                    step, tr.state, 1, extra_batch_fn=tr.extra),
                           TRAIN_FAMILIES)
    it.close()
    check(not prof["hand_kernel_launches"], f"{PATH10} {name}: hand kernels in the loop "
          f"{prof['hand_kernel_launches']}")
    line["profile_5_loop_steps"] = prof

    # B7's input on one validate batch (phase 4), and validate card vs CPU on
    # one group in f32 (TF32 off, as the CPU computes)
    vit = iter(GroupLoader(tr.test_ds, int(cfg.TEST.BATCH_SIZE), shuffle=False,
                           drop_last=False, prefetch=0))
    vb = next(vit)
    vit.close()
    with capture_first_calls([(dec, "decode_heatmaps_kernel")]) as seen:
        tr.eval_step(tr.base.params, tr.prepare(vb))
    one = {k: v[:1] for k, v in vb.items()}
    weights = {k: v.detach().cpu() for k, v in tr.base.params.state_dict().items()}
    outs = []
    t = time.perf_counter()
    for device in (dev, torch.device("cpu")):
        net = build_model(cfg, bf16=False)
        net.load_state_dict(weights)
        net.to(device)
        with quant._full_fp32():
            out = make_eval_step(net, cfg, flip_pairs=tr.train_ds.flip_pairs, device=device)(
                net, make_prepare_fn(cfg, device)(one))
        outs.append({k: out[k].float().cpu() for k in ("loss", "preds", "maxvals")})
    card, cpu = outs
    lerr = float((card["loss"] - cpu["loss"]).abs() / cpu["loss"].abs().clamp(min=1e-30))
    merr = float((card["maxvals"] - cpu["maxvals"]).abs().max())
    same = float(((card["preds"] - cpu["preds"]).abs().amax(-1) <= 1e-3).float().mean())
    check(lerr <= 1e-4 and merr <= 1e-3 and same >= 0.9,
          f"{PATH10} {name}: validate card vs CPU: loss {lerr}, maxvals {merr}, joints {same}")
    line["validate_card_vs_cpu"] = {"loss_rel": lerr, "maxvals_max_abs": merr,
                                    "joints_within_1e-3_px": same,
                                    "cpu_s": time.perf_counter() - t}

    if resume_from:  # the resumed model's first loss against a fresh one's on that batch
        lo = GroupLoader(ds, bs, prefetch=0, num_threads=threads)
        lo.set_epoch(0)
        it = iter(lo)
        hb0 = next(it)
        it.close()
        b0 = tr.prepare(hb0)
        b0 = tr.extra(hb0, b0) if tr.extra is not None else b0
        fresh = build_model(cfg, bf16=True, generator=torch.Generator().manual_seed(int(cfg.SEED)))
        tx = make_optimizer(cfg, steps_per_epoch=steps)
        _, m = make_train_step(fresh, cfg, tx, device=dev)(init_train_state(fresh, tx, dev), b0)
        line["fresh_model_loss_on_the_first_batch"] = float(m["loss"])
        check(line["loss_first"] < line["fresh_model_loss_on_the_first_batch"],
              f"{PATH10} {name}: the resumed model's first loss {line['loss_first']} is not "
              f"below a fresh model's {line['fresh_model_loss_on_the_first_batch']}")
    line["final_state"] = os.path.join(tr.output_dir, "final_state")
    return line, {"b7": seen["decode_heatmaps_kernel"]}


def path10(tmp: str, dev, reset_counts, read_counts, card: str) -> dict:
    """Path 10: the image fixture under ``tmp``
    (data/synthetic.write_image_fixture: MPII's 1280x720 and H36M's
    1000x1000 JPEGs in zips), then step 1, MPII pretraining on
    PATH10_PRESETS[0], and step 2, the mixed retrain on PATH10_PRESETS[1]
    warm-started from step 1's final_state (:func:`path10_step`). Returns
    B7's input on a validate batch of each step, its launches in each main
    path, and step 2's final_state (path 11 serves it)."""
    from posetpu_torch.data.synthetic import write_image_fixture

    t = time.perf_counter()
    counts = write_image_fixture(os.path.join(tmp, "data"))
    log(f"{PATH10}: fixture {counts} written in {time.perf_counter() - t:.1f} s")
    out = {"b7": {}, "launches": {}}
    resume = ""
    for i, preset in enumerate(PATH10_PRESETS):
        line, got = path10_step(preset, tmp, dev, reset_counts, read_counts, resume)
        resume = line["final_state"]
        out["b7"][f"step {i + 1}"] = got["b7"]
        out["launches"][f"step {i + 1}"] = line["b7_launches"]
        log(f"{PATH10}, step {i + 1}: " + json.dumps(line) + f" | {card}")
    out["final_state"] = resume
    return out


def reference_checkpoint(path: str, seed: int, s: int) -> float:
    """A reference-layout ``final_state.pth.tar`` written from ``seed``: a
    ResNet-50 MultiViewPose (kernels 0.05 N(0, 1), BN weight and bias N(0, 1),
    running mean 0.1 N(0, 1), running var U(0.5, 1.5), as
    tests/test_torch_oracle_full.make_resnet50_state) with the 12
    ChannelWiseFC weights [s, s] U(0, 0.1), inside the reference's envelope
    ({"state_dict": ...} with DDP's ``module.`` prefixes). Returns the
    seconds it took."""
    import torch

    t = time.perf_counter()
    g = torch.Generator().manual_seed(seed)
    st = {}

    def conv(name, o, i, k):
        st[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) * 0.05

    def bn(name, c):
        st[f"{name}.weight"] = torch.randn(c, generator=g)
        st[f"{name}.bias"] = torch.randn(c, generator=g)
        st[f"{name}.running_mean"] = torch.randn(c, generator=g) * 0.1
        st[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=g)

    conv("resnet.conv1", 64, 3, 7)
    bn("resnet.bn1", 64)
    inp = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)), 1):
        for b in range(blocks):
            p = f"resnet.layer{stage}.{b}"
            conv(f"{p}.conv1", planes, inp, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0", planes * 4, inp, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inp = planes * 4
    for i in range(3):
        st[f"resnet.deconv_layers.{3 * i}.weight"] = torch.randn(inp, 256, 4, 4,
                                                                 generator=g) * 0.05
        bn(f"resnet.deconv_layers.{3 * i + 1}", 256)
        inp = 256
    conv("resnet.final_layer", 16, 256, 1)
    st["resnet.final_layer.bias"] = torch.randn(16, generator=g)
    for i in range(12):
        st[f"aggre_layer.aggre.{i}.weight"] = torch.rand(s, s, generator=g) * 0.1
    torch.save({"epoch": 30, "state_dict": {f"module.{k}": v for k, v in st.items()},
                "perf": 0.0}, path)
    return time.perf_counter() - t


def path11(tmp: str, final_state: str, dev, reset_counts, read_counts, card: str) -> dict:
    """Path 11, serving a trained checkpoint, through the validate and
    convert CLIs on path 10's fixture under ``tmp`` (24 H36M validation
    groups of 1000x1000 JPEGs, 8 a batch):

    - 11a: ``cli.validate.run`` on path 10's step-2 ``final_state``
      (PATH10_PRESETS[1], the bf16 ResNet-50 without the bank) at the CLI's
      defaults, then with ``--int8 --calib-batches 2 --int8-act4 l12
      --int8-subpixel deconv0 --flip-test``, then in float with
      ``--flip-test`` (int8 against float alone);
    - 11b: :func:`reference_checkpoint` (S = 4096, 805 MB of bank in f32),
      ``cli.convert`` of it, then ``cli.validate`` with ``--state
      <converted> --int8 --qat-steps 4 --calib-batches 2 --flip-test`` under
      experiments/mixed/resnet50/256_fusion.yaml (the bank's bf16 product
      and fuse routing on).

    Each run's main path must launch B7 once a validate batch and no other
    hand kernel. Returns its lines, B7's input on one int8 validate batch,
    B7's launches and what the card-vs-CPU checks take."""
    import torch

    from posetpu_torch.cli import common
    from posetpu_torch.cli import convert as convert_cli
    from posetpu_torch.cli import validate as validate_cli
    from posetpu_torch.ops import decode as dec
    from posetpu_torch.train import loop, qat, serve

    have_h5 = True
    try:
        import h5py  # noqa: F401
    except ImportError:
        have_h5 = False
    phases, kept = {}, {}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[key] = time.perf_counter() - t
            kept[key] = (a, out)
            return out
        return run

    def validate_run(tag, preset, *extra):
        args = validate_cli.parse_args(
            ["--cfg", str(ROOT / preset), "--modelDir", f"{tmp}/output", "--logDir",
             f"{tmp}/log", "--dataDir", tmp, *extra])
        cfg = common.load_cfg(args)
        phases.clear()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        perf, _, preds, _ = validate_cli.run(cfg, args, device=dev, dump=have_h5)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = {k: v for k, v in read_counts().items() if v}
        (_, loader, dataset, eval_step, qvars, *_), _ = kept["validate"]
        n_val = len(loader)
        check(counts == {"decode_heatmaps_kernel": n_val},
              f"{PATH11} {tag}: hand kernel launches {counts}, {n_val} validate batches")
        check(np.isfinite(preds).all() and preds.shape == (len(dataset) * VIEWS, 16, 3),
              f"{PATH11} {tag}: preds {preds.shape}, finite {np.isfinite(preds).all()}")
        line = {"run": tag, "preset": preset, "flags": list(extra), "perf": perf,
                "groups": len(dataset), "validate_batches": n_val, "b7_launches": n_val,
                "validate_groups_per_s": len(dataset) / phases["validate"],
                "validate_s": phases["validate"], "run_s": run_s,
                "load_s": phases["load"],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        ctx = {"cfg": cfg, "loader": loader, "dataset": dataset, "eval_step": eval_step,
               "qvars": qvars}
        if "quantize" in phases:
            line["calibrate_and_quantize_s"] = phases["quantize"]
            ctx["quant"] = kept["quantize"][1]
        return line, preds, ctx

    orig = loop.validate, serve.build_quant_from_variables, common.load_model_variables
    loop.validate = timed("validate", orig[0])
    serve.build_quant_from_variables = timed("quantize", orig[1])
    common.load_model_variables = timed("load", orig[2])
    try:
        # ---- 11a: the float and the int8 serving of path 10's checkpoint
        state = ["--state", final_state]
        float_line, float_preds, float_ctx = validate_run("float", PATH10_PRESETS[1], *state)
        int8_line, int8_preds, int8_ctx = validate_run(
            "int8", PATH10_PRESETS[1], *state, "--int8", "--calib-batches", "2",
            "--int8-act4", "l12", "--int8-subpixel", "deconv0", "--flip-test")
        # the float run with the flip test too: int8 against float alone
        flip_line, flip_preds, flip_ctx = validate_run("float, flip test", PATH10_PRESETS[1],
                                                       *state, "--flip-test")

        def px(a, b):
            d = np.abs(a[..., :2] - b[..., :2]).max(-1)
            return {"max": float(d.max()), "mean": float(d.mean())}

        log(f"{PATH11}, 11a: " + json.dumps({
            "float": float_line, "int8": int8_line, "float_flip_test": flip_line,
            "int8_vs_float_px": px(int8_preds, float_preds),
            "int8_vs_float_both_flip_test_px": px(int8_preds, flip_preds)}) + f" | {card}")

        # ---- 11b: a reference checkpoint converted, then QAT int8 serving
        ref_path = os.path.join(tmp, "reference", "final_state.pth.tar")
        os.makedirs(os.path.dirname(ref_path))
        conv_args = convert_cli.parse_args(
            ["--cfg", str(ROOT / PATH11_PRESET), "--dataDir", tmp, "--torch", ref_path,
             "--out", os.path.join(tmp, "converted", "final_state")])
        conv_cfg = common.load_cfg(conv_args)
        s_bank = int(np.prod(conv_cfg.NETWORK.HEATMAP_SIZE))
        write_s = reference_checkpoint(ref_path, seed=11, s=s_bank)
        t = time.perf_counter()
        converted = convert_cli.run(conv_cfg, conv_args)
        convert_s = time.perf_counter() - t
        shutil.rmtree(os.path.dirname(ref_path))
        gc.collect()
        steps = []  # a CUDA event at each QAT step's start, one after the last

        def mark(fn):
            def run(*a, **kw):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                steps.append(e)
                return fn(*a, **kw)
            return run

        def teacher_marked(runner, *a, **kw):  # each QAT step starts with the teacher
            if isinstance(runner, qat._Recorder):
                return mark(orig_fwd)(runner, *a, **kw)
            return orig_fwd(runner, *a, **kw)

        orig_fwd, orig_qw = qat._forward, qat.quantize_weights
        qat._forward, qat.quantize_weights = teacher_marked, mark(orig_qw)
        losses = []
        orig_ft = qat._finetune

        def finetune(*a, **kw):
            q, info = orig_ft(*a, **kw)
            losses.extend(info["losses"])
            return q, info

        qat._finetune = finetune
        try:
            qat_line, _, qat_ctx = validate_run(
                "qat", PATH11_PRESET, "--state", converted[:-3], "--int8", "--qat-steps", "4",
                "--calib-batches", "2", "--flip-test")
        finally:
            qat._forward, qat.quantize_weights, qat._finetune = orig_fwd, orig_qw, orig_ft
        step_ms = [a.elapsed_time(b) for a, b in zip(steps[:-1], steps[1:])]
        check(len(losses) == 4 and len(step_ms) == 4 and all(np.isfinite(losses)),
              f"{PATH11} 11b: QAT losses {losses}, {len(step_ms)} steps timed")
        bank = qat_ctx["qvars"]["bank"]
        check(bank is not None and bank.dtype == torch.bfloat16 and bank.device.type == dev.type
              and bank.shape == (12, s_bank, s_bank), f"{PATH11} 11b: no bf16 bank on the card")
        del bank
        log(f"{PATH11}, 11b: " + json.dumps({
            **qat_line, "qat_losses": losses, "qat_step_ms": step_ms,
            "write_reference_s": write_s, "convert_s": convert_s}) + f" | {card}")
    finally:
        loop.validate, serve.build_quant_from_variables, common.load_model_variables = orig

    from posetpu_torch.data.prepare import make_prepare_fn

    # the eval step alone on one held batch of each run, the rates that
    # compare the int8 trunk with the float one (a validate run's 3 batches
    # are too few, its first holds the loader's start-up)
    def held_batch(ctx):
        it = iter(ctx["loader"])
        host = next(it)
        it.close()
        return make_prepare_fn(ctx["cfg"], dev)(host)

    def eval_step_alone(ctx, batch):
        step = lambda: ctx["eval_step"](ctx["qvars"], batch)  # noqa: E731
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(EVAL_ITERS + 1)]
        t = time.perf_counter()
        ev[0].record()
        for e in ev[1:]:
            step()
            e.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ms = sorted(a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:]))
        groups = int(batch["images"].shape[0])
        return {"groups_a_batch": groups, "batches": EVAL_ITERS,
                "images_a_batch": groups * VIEWS * (2 if ctx["cfg"].TEST.FLIP_TEST else 1),
                "ms_median": ms[EVAL_ITERS // 2], "ms_min": ms[0], "ms_max": ms[-1],
                "groups_per_s": groups * EVAL_ITERS / wall,
                "profile": profile_request(step, PATH11_FAMILIES)}

    alone = {}
    for tag, ctx in (("float", float_ctx), ("float, flip test", flip_ctx),
                     ("int8, flip test", int8_ctx), ("11b qat, flip test, bank", qat_ctx)):
        alone[tag] = eval_step_alone(ctx, held_batch(ctx))
    log(f"{PATH11}, the eval step alone on one held batch ({EVAL_ITERS} batches after 3, CUDA "
        f"events; groups/s on the host clock ending in a synchronize): " + json.dumps(alone)
        + f" | {card}")

    # B7's input on one int8 validate batch (phase 4), outside the main path;
    # that batch prepared on the CPU for the card-vs-CPU checks (phase 5)

    it = iter(int8_ctx["loader"])
    host = next(it)
    it.close()
    with capture_first_calls([(dec, "decode_heatmaps_kernel")]) as seen:
        int8_ctx["eval_step"](int8_ctx["qvars"], make_prepare_fn(int8_ctx["cfg"], dev)(host))
    one = {k: v[:1] for k, v in host.items()}
    return {"b7": seen["decode_heatmaps_kernel"],
            "launches": {"11a float": float_line["b7_launches"],
                         "11a int8": int8_line["b7_launches"],
                         "11a float, flip test": flip_line["b7_launches"],
                         "11b qat": qat_line["b7_launches"]},
            "card_vs_cpu": [(tag, ctx["cfg"], ctx["dataset"].flip_pairs, ctx["quant"],
                             make_prepare_fn(ctx["cfg"], "cpu")(one))
                            for tag, ctx in (("11a int8", int8_ctx), ("11b qat", qat_ctx))]}


def _to(tree, device):
    """A nest of dicts of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def eval_step_card_vs_cpu(cfg, flip_pairs, quant, batch, card) -> tuple[str, list]:
    """``make_quant_eval_step`` on one prepared batch (on the CPU) through
    the same qparams (and bank) on the card and on the CPU. Without the
    bank: heatmaps and maxvals equal and every pred within 1e-4 px (the
    inverse affine's tiny matmul may round otherwise). With it, cuBLAS's
    bf16 product sums in another order than the CPU's: the heatmaps and
    maxvals within one bf16 step of the largest map value times the
    routing's 0.6, and the preds of every joint whose map has a clear peak
    (maximum > 0, its two best pixels and the neighbours that set the
    quarter-pixel nudge more than two such steps apart) within 1e-4 px.
    Returns (its line, failures)."""
    import torch

    from posetpu_torch.train.serve import make_quant_eval_step

    qparams, qfwd, bank = quant
    outs = []
    for device in (card, torch.device("cpu")):
        step = make_quant_eval_step(qfwd, cfg, flip_pairs=flip_pairs,
                                    has_aggre=bank is not None, device=device)
        out = step({"q": _to(qparams, device), "bank": None if bank is None else bank.to(device)},
                   {k: v.to(device) for k, v in batch.items()})
        outs.append({k: out[k].float().cpu() for k in ("preds", "maxvals", "heatmaps")})
    got, ref = outs
    hm = ref["heatmaps"]
    hm_err = float((got["heatmaps"] - hm).abs().max())
    bound = 0.0 if bank is None else 0.6 * 2.0 ** -7 * float(hm.abs().max())
    m_err = float((got["maxvals"] - ref["maxvals"]).abs().max())
    p_err = (got["preds"] - ref["preds"]).abs().amax(-1)
    sure = torch.ones_like(p_err, dtype=torch.bool)
    if bank is not None:
        n, v, h, w, j = hm.shape
        maps = hm.movedim(-1, 2).reshape(n, v, j, h * w)
        top2 = maps.topk(2, dim=-1).values
        sure &= (ref["maxvals"] > 0) & (top2[..., 0] - top2[..., 1] > 2 * bound)
        idx = maps.argmax(-1)
        py, px = idx // w, idx % w
        pick = lambda dy, dx: maps.gather(-1, ((py + dy).clamp(0, h - 1) * w  # noqa: E731
                                               + (px + dx).clamp(0, w - 1))[..., None])[..., 0]
        inner = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
        sure &= ~(inner & (((pick(0, 1) - pick(0, -1)).abs() <= 2 * bound)
                           | ((pick(1, 0) - pick(-1, 0)).abs() <= 2 * bound)))
    clear = float(p_err[sure].max()) if bool(sure.any()) else float("nan")
    failures = []
    if hm_err > bound or m_err > bound:
        failures.append(f"heatmaps {hm_err}, maxvals {m_err} over {bound}")
    if bool(sure.any()) and clear > 1e-4:
        failures.append(f"preds {clear} px on {int(sure.sum())} joints with a clear peak")
    line = (f"heatmaps max abs diff {hm_err} (bound {bound}), maxvals {m_err}, preds {clear} px "
            f"on the {int(sure.sum())} of {sure.numel()} joints with a clear peak (all joints: "
            f"{float(p_err.max())})")
    return line, failures


def qat_card_vs_cpu(card) -> tuple[str, list]:
    """One QAT step of a ResNet-18 at 64x64 on 2 groups (8 images) from one
    set of trained-like weights (:func:`trained_like_`) and one calibration
    (the CPU's), on the card and on the CPU:

    - float64: the loss within 1e-10 relative and every tuned int8 weight
      equal (2.3e-15 and none off, measured);
    - float32, the package's dtype: the fake-quantised forward is chaotic
      there (a conv sum in another order rounds one activation the other
      way and the difference spreads, tests/test_torch_qat.py), so the
      step's loss is reported, not held, as is that of the entry point with
      each device calibrating itself. What is held is each full-f32 pass of
      the card's step against a float64 recomputation on the CPU from the
      card's own inputs: the teacher's heatmaps, and the head's output and
      its two gradients (the weights' and the input's), each within
      F32_PASS_BOUND of its largest magnitude. cuDNN's TF32 default, which
      ``_full_fp32`` turns off for the step and its backward, rounds each
      product's operands to 10 bits; the same passes with ``_full_fp32``
      left out are printed beside.

    Returns (its line, failures)."""
    from contextlib import nullcontext

    import torch

    from posetpu_torch.models import quant
    from posetpu_torch.models.pose_resnet import PoseResNet
    from posetpu_torch.train import qat

    model = PoseResNet(num_layers=18)
    trained_like_(model, torch.Generator().manual_seed(12))
    model.eval()
    dks = model.deconv_kernels
    x = np.random.RandomState(12).randn(2 * VIEWS, 64, 64, 3).astype(np.float32)
    folded, scales = quant.calibrate(model, [x], "cpu")
    folded64 = {k: (w.astype(np.float64), b.astype(np.float64)) for k, (w, b) in folded.items()}
    t = time.perf_counter()

    def finetune(f, device):
        return qat._finetune(f, scales, 18, dks, [x], lr=3e-6, target_fn=None, device=device)

    def f32_step_on_card(full_fp32: bool):
        """The card's f32 step with its teacher's heatmaps and the head's
        inputs, weights, output and gradients captured."""
        cap = {}
        keep = lambda key: (lambda g: cap.__setitem__(key, g.detach().clone()))  # noqa: E731
        orig = qat._forward, qat._FakeQuantRunner, qat._full_fp32

        def forward(runner, *a, **kw):
            out = orig[0](runner, *a, **kw)
            if isinstance(runner, qat._Recorder):
                cap["teacher"] = out.detach().clone()
            return out

        class Runner(orig[1]):
            def conv_f32(self, h, s_h, name, stride=1):
                if name != "final":  # the blocks' last convs
                    return super().conv_f32(h, s_h, name, stride)
                w, b = self.p[name]
                cap.update(h=h.detach().clone(), wq=self._fq_w(w).detach().clone(),
                           b=b.detach().clone(), stride=stride)
                w.register_hook(keep("gw"))
                h.register_hook(keep("gh"))
                y = super().conv_f32(h, s_h, name, stride)
                y.register_hook(keep("gy"))
                cap["y"] = y.detach().clone()
                return y

        qat._forward, qat._FakeQuantRunner = forward, Runner
        if not full_fp32:
            qat._full_fp32 = nullcontext
        try:
            _, info = finetune(folded, card)
        finally:
            qat._forward, qat._FakeQuantRunner, qat._full_fp32 = orig
        return cap, info

    def f32_pass_errors(cap):
        """Each captured pass against float64 on the CPU from the same
        inputs, relative to its largest magnitude."""
        f64 = lambda v: v.cpu().double()  # noqa: E731
        rel = lambda got, ref: float((f64(got) - ref).abs().max() / ref.abs().max())  # noqa: E731
        with torch.no_grad():
            teacher = quant._forward(quant._Recorder(folded64, "cpu"),
                                     torch.from_numpy(x).double(), 18, dks)
        h, wq = f64(cap["h"]).requires_grad_(), f64(cap["wq"]).requires_grad_()
        y = quant._conv_f32(h, wq, stride=cap["stride"]) + f64(cap["b"])
        y.backward(f64(cap["gy"]))
        return {"teacher": rel(cap["teacher"], teacher), "head": rel(cap["y"], y.detach()),
                "head weight grad": rel(cap["gw"], wq.grad),
                "head input grad": rel(cap["gh"], h.grad)}

    q64 = [finetune(folded64, device) for device in (card, torch.device("cpu"))]
    cap, info32 = f32_step_on_card(full_fp32=True)
    passes = f32_pass_errors(cap)
    tf32 = f32_pass_errors(f32_step_on_card(full_fp32=False)[0])
    cpu32 = finetune(folded, "cpu")[1]
    entry = [qat.qat_finetune(model, [x], [x], device=device)
             for device in (card, torch.device("cpu"))]

    def loss_rel(ia, ib):
        return abs(ia["losses"][0] - ib["losses"][0]) / abs(ib["losses"][0])

    def weights_off(qa, qb):
        off = total = worst = 0
        for k, wq in qb["weights"].items():
            d = (qa["weights"][k].cpu().int() - wq.int()).abs()
            off, total, worst = off + int((d > 0).sum()), total + d.numel(), max(worst, int(d.max()))
        return off / total, worst

    (qa, ia), (qb, ib) = q64
    l64, (off64, worst64) = loss_rel(ia, ib), weights_off(qa, qb)
    l32 = loss_rel(entry[0][1], entry[1][1])
    off32, worst32 = weights_off(entry[0][0], entry[1][0])
    failures = []
    if not (l64 <= 1e-10 and off64 == 0):
        failures.append(f"f64: loss {l64}, int8 weights off {off64} (at most {worst64})")
    over = {k: v for k, v in passes.items() if not v <= F32_PASS_BOUND}
    if over:
        failures.append(f"f32 passes over {F32_PASS_BOUND}: {over}")
    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())  # noqa: E731
    line = (f"float64: loss relative {l64:.3e}, int8 weights off by one {off64:.2e} (at most "
            f"{worst64}); float32 passes of the card's step against float64 (bound "
            f"{F32_PASS_BOUND}): {fmt(passes)}; the same with TF32 allowed: {fmt(tf32)}; "
            f"float32 loss relative, one calibration {loss_rel(info32, cpu32):.3e}, the entry "
            f"point with each device calibrating {l32:.3e}, int8 weights off {off32:.2e} (at "
            f"most {worst32}) ({time.perf_counter() - t:.1f} s)")
    return line, failures


def kernel_registers(build_log: str, kernel: str) -> dict:
    """Registers per thread of B8a's two instances, from ptxas' report:
    {"wide": n, "narrow": n} (the template argument: 64-wide conv1/conv2
    tiles at Cm <= 64)."""
    import re

    regs, which = {}, None
    for line in build_log.splitlines():
        m = re.search(rf"Compiling entry function '(\w*{kernel}\w*)'", line)
        if m:
            which = "narrow" if "ILb1E" in m.group(1) else "wide"
        m = re.search(r"Used (\d+) registers", line)
        if m and which:
            regs[which], which = int(m.group(1)), None
    return regs


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check((ROOT / "posetpu_torch" / "csrc").is_dir(),
          f"posetpu_torch/csrc not found beside {Path(__file__).name}: "
          f"run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from posetpu_torch.config import default_config
    from posetpu_torch.core.inference import (
        final_preds,
        final_preds_jns,
        final_preds_packed,
        flip_test_merge_jns,
        fuse_routing_jns,
    )
    from posetpu_torch.data.base import union_flip_pairs
    from posetpu_torch.data.synthetic import make_camera_ring, tile_cameras
    from posetpu_torch.geometry.triangulate import triangulate_points
    from posetpu_torch.models import quant
    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.ops import _build
    from posetpu_torch.ops import aggregation as agg
    from posetpu_torch.ops import decode as dec
    from posetpu_torch.ops import deconv as dcv
    from posetpu_torch.ops import phase_tail as pt
    from posetpu_torch.ops import resblock as rb
    from posetpu_torch.ops.heatmap import decode_heatmaps, phase_index_tables
    from posetpu_torch.serving import (
        build_float_pipeline,
        build_serving_pipeline,
        pack_hwcn,
    )
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.train.gan import init_discriminator_states, make_adversarial_train_step
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_train_step

    t_start = time.perf_counter()
    # ------------------------------------------------------------ 1. the card
    card = card_line()
    dev = torch.device("cuda")
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ------------------------------------------------------------ 2. build
    sources = sorted(p.stem for p in (ROOT / "posetpu_torch" / "csrc").glob("*.cu"))
    secs = _build.build(sources)
    log(f"build: {sources} in {secs:.1f} s")
    for s in sources:
        for line in _build.build_log(s).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {s}: {line.strip()}")

    # ------------------------------------------------------------ 3. the paths
    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE = np.array([256, 256])
    cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64])
    cfg.NETWORK.AGGRE = True
    cfg.TEST.POST_PROCESS = True  # the float path's quarter-pixel nudge
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    model = get_multiview_pose_net(cfg, generator=gen)
    trained_like_(model, gen)
    model.eval()
    rs = np.random.RandomState(0)
    calib = [rs.randn(8, 256, 256, 3).astype(np.float32) for _ in range(2)]
    with torch.no_grad():  # heatmaps into the [-1, 1] range a trained head gives
        hm, _, _ = model.resnet(torch.from_numpy(calib[0][:1]))
        model.resnet.final_layer.weight.mul_(1.0 / float(hm.abs().max()))
    pipe = build_serving_pipeline(cfg, model, calib, device=dev)
    torch.cuda.synchronize()
    log(f"model + path 1 calibration + quantization: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe_pre = build_serving_pipeline(cfg, model, calib, flip_test="premirrored",
                                      agg_w4=True, device=dev)
    pipe_flip = build_serving_pipeline(cfg, model, calib, flip_test=True,
                                       agg_w4=True, device=dev)
    bank4 = pipe_pre.params["qagg"]["wq4"]
    s_bank = 64 * 64
    check(bank4.dtype == torch.uint8 and bank4.is_cuda
          and bank4.numel() * bank4.element_size() == 4 * 3 * s_bank * s_bank // 2,
          f"the s4 bank is not nibble-packed on the card: {bank4.dtype} {tuple(bank4.shape)}")
    act4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
        f"layer2_{i}.out" for i in range(4))
    q3, fwd3 = quant.quantize_pose_resnet(model.resnet, calib, jns_head="phase",
                                          phase_kernel=1, stem_s2d="pre",
                                          subpixel_deconvs={"deconv0"}, act4=act4,
                                          act4_mode="s4", device=dev)
    tables3 = phase_index_tables((64, 64), levels=1)
    qagg3 = agg.aggregation_device_params(quant.permute_aggregation_packed(
        quant.quantize_aggregation_grouped(model.aggre_layer.weight), tables3), dev)
    torch.cuda.synchronize()
    log(f"paths 2 and 3 calibration + quantization: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q5, fwd5 = quant.quantize_pose_resnet(model.resnet, calib, device=dev)  # JAX's defaults
    p5a, fwd5a = quant.make_fused_forward(model.resnet, q5, device=dev)
    p5b, fwd5b = quant.make_fused_forward(model.resnet, q5, pallas_blocks=True, device=dev)
    blocks5 = list(p5b["fused"])
    check(len(blocks5) == 13 and not p5a["fused"] and len(p5b["deconv"]) == 3,
          f"path 5: fused blocks {blocks5}, {len(p5b['deconv'])} deconvs")
    torch.cuda.synchronize()
    log(f"path 5 calibration + quantization + kernel arguments: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q6, fwd6 = quant.quantize_pose_resnet(model.resnet, calib, jns_head=True, device=dev)
    qagg6 = quant.quantize_aggregation(model.aggre_layer.weight, device=dev)
    pipe_plain = build_serving_pipeline(cfg, model, calib, aggre_kernel=False, device=dev)
    torch.cuda.synchronize()
    log(f"path 6 calibration + quantization, path 1 without the aggregation kernel: "
        f"{time.perf_counter() - t0:.1f} s")

    images = rs.randint(0, 256, (GROUPS, VIEWS, 256, 256, 3)).astype(np.uint8)
    center = torch.full((GROUPS, VIEWS, 2), 500.0, device=dev)
    scale = torch.full((GROUPS, VIEWS, 2), 2.5, device=dev)
    is_h36m = torch.ones(GROUPS, device=dev)
    cams = tile_cameras(make_camera_ring(device=dev), GROUPS)
    cams_small = tile_cameras(make_camera_ring(device=dev), SMALL_GROUPS)
    g = SMALL_GROUPS
    views_f32 = rs.randn(g, VIEWS, 256, 256, 3).astype(np.float32)
    frames5 = rs.randn(GROUPS * VIEWS, 256, 256, 3).astype(np.float32)  # path 5's input

    # every kernel wrapper, by the module attribute its callers look up
    wrappers = {"fused_subpixel_deconv_batched": pt, "fused_phase_tail2": pt,
                "aggregation_grouped": agg, "quantize_heatmaps": agg,
                "aggregation_grouped_s4": agg,
                "fused_phase_tail": pt, "fused_subpixel_deconv": pt,
                "decode_heatmaps_kernel": dec, "fused_bottleneck": rb,
                "fused_bottleneck_v2": rb, "deconv.fused_subpixel_deconv": dcv,
                "fused_subpixel_deconv_head": dcv}
    wrapper = lambda name: getattr(wrappers[name], name.split(".")[-1])

    def triangulated(preds, maxvals, cams_):
        return preds, maxvals, triangulate_points(preds, cams_, (maxvals > 0.0).float())

    def serve_with(p, n_groups=GROUPS, cams_=cams):
        return lambda x: triangulated(*p.infer(p.params, x, center[:n_groups],
                                               scale[:n_groups], is_h36m[:n_groups]),
                                      cams_)

    def serve3(x):
        """Path 3: the one-level tail's forward and the rest of the serving
        pipeline, assembled from the package's functions."""
        u8_quant = quant.make_u8_quant(q3, cfg.DATASET.MEAN, cfg.DATASET.STD)
        hm3 = fwd3(q3, u8_quant(x.permute(3, 0, 1, 2)).contiguous())  # [J, N*V, S]
        raw = hm3.reshape(hm3.shape[0], g, VIEWS, hm3.shape[-1])
        out = fuse_routing_jns(raw, agg.aggregation_grouped(qagg3, raw), is_h36m[:g])
        return triangulated(*final_preds_packed(out, center[:g], scale[:g], (64, 64),
                                                tables3), cams_small)

    pipe4 = build_float_pipeline(cfg, model, flip_test=True, device=dev)
    pairs6 = union_flip_pairs()

    def infer6(q, qagg, x, center_, scale_, is_h36m_):
        """Path 6 (bench.py:_build_int8(tail="jns", flip_test=True)): the
        images and their W-mirror in one int8 forward to S-minor heatmaps,
        the flip merge, the per-pair bank, routing and the S-minor decode,
        assembled from the package's functions. x [N*V, H, W, 3] uint8."""
        u8_quant = quant.make_u8_quant(q, cfg.DATASET.MEAN, cfg.DATASET.STD)
        hm = fwd6(q, u8_quant(torch.cat([x, x.flip(2)])))  # [J, 2*N*V, S], mirror after
        hm, hm_f = hm.split(hm.shape[1] // 2, dim=1)
        hm = flip_test_merge_jns(hm, hm_f, pairs6, (64, 64))
        raw = hm.reshape(hm.shape[0], -1, VIEWS, hm.shape[-1])
        out = fuse_routing_jns(raw, quant.aggregation_int8_apply_jns(qagg, raw), is_h36m_)
        return final_preds_jns(out, center_, scale_, (64, 64))

    serve6 = lambda x: triangulated(*infer6(q6, qagg6, x, center, scale, is_h36m), cams)
    prepare6 = lambda: torch.from_numpy(images.reshape(GROUPS * VIEWS, 256, 256, 3)).to(dev)

    def heatmaps5(fwd, params, x):
        """Path 5's forward [N, h, w, J] as [G, V, J, h, w] maps."""
        hm = fwd(params, x)
        n, hh, ww, j = hm.shape
        return hm.permute(0, 3, 1, 2).reshape(n // VIEWS, VIEWS, j, hh, ww)

    def serve5(fwd, params):
        """Path 5: a row-major forward, decode (B7) and triangulation,
        assembled from the package's functions."""
        return lambda x: triangulated(*final_preds(heatmaps5(fwd, params, x), center, scale),
                                      cams)

    frames5_pinned = torch.from_numpy(frames5).pin_memory()
    make_x5 = lambda: frames5_pinned.to(dev, non_blocking=True)

    @contextmanager
    def identity_blocks_through_v2():
        """Send make_fused_forward's identity-residual blocks to B8b
        (imgs=2); the projection block stays on B8a."""
        orig = rb.fused_bottleneck

        def routed(x, args, *, h, w):
            if "wd" in args:
                return orig(x, args, h=h, w=w)
            return rb.fused_bottleneck_v2(x, args, h=h, w=w, imgs=2)
        routed.launches = 0  # B8a counts on its module-level name, which is this
        rb.fused_bottleneck = routed
        try:
            yield
        finally:
            rb.fused_bottleneck = orig

    launches_by_path = {}

    def drive(label, serve, make_x, n_groups, requests, expect):
        """Serve ``requests`` requests (the first warms up); frames/s over the
        rest; the launch counts of this path alone."""
        for name in wrappers:
            wrapper(name).launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(requests):
            torch.cuda.synchronize()
            t = time.perf_counter()
            preds, maxvals, pts3d = serve(make_x())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = {name: wrapper(name).launches for name in wrappers}
        launches_by_path[label] = counts
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for name in expect:
            check(counts[name] > 0, f"{label}: {name} never launched")
        check(tuple(preds.shape) == (n_groups, VIEWS, 16, 2), f"{label}: preds {tuple(preds.shape)}")
        check(tuple(maxvals.shape) == (n_groups, VIEWS, 16), f"{label}: maxvals {tuple(maxvals.shape)}")
        check(tuple(pts3d.shape) == (n_groups, 16, 3), f"{label}: pts3d {tuple(pts3d.shape)}")
        for name, t in (("preds", preds), ("maxvals", maxvals), ("pts3d", pts3d)):
            check(bool(torch.isfinite(t).all()), f"{label}: non-finite {name}")
        check(float(maxvals.std()) > 0, f"{label}: maxvals are constant")
        fps = (requests - 1) * n_groups * VIEWS / sum(times[1:])
        per = sorted(n_groups * VIEWS / t for t in times[1:])
        log(f"{label}: {requests} requests x {n_groups * VIEWS} frames, request s "
            f"{[round(t, 4) for t in times]}, {fps:.1f} frames/s over the last "
            f"{requests - 1} (a request: median {statistics.median(per):.1f}, min-max "
            f"{per[0]:.1f}-{per[-1]:.1f}), peak {peak_gib:.2f} GiB, launches "
            f"{ {k: v for k, v in counts.items() if v} } | {card}")
        return preds, maxvals

    drive("path 1 (defaults)", serve_with(pipe), lambda: pipe.prepare(images), GROUPS, 9,
          ["fused_subpixel_deconv_batched", "fused_phase_tail2", "aggregation_grouped",
           "quantize_heatmaps"])
    p_pre, m_pre = drive(
        "path 2 (premirrored flip, s4 bank)", serve_with(pipe_pre),
        lambda: pipe_pre.prepare(images), GROUPS, 9,
        ["fused_subpixel_deconv_batched", "fused_phase_tail2", "aggregation_grouped_s4",
         "quantize_heatmaps"])
    check(launches_by_path["path 2 (premirrored flip, s4 bank)"]["quantize_heatmaps"] == 9,
          "path 2: the quantize kernel is not launched once a request")
    pt.SUBPIX_BATCHED = False
    try:
        drive("path 3 (one-level tail, per-pair deconv0)", serve3,
              lambda: pipe.prepare(images[:g]), g, 3,
              ["fused_subpixel_deconv", "fused_phase_tail", "aggregation_grouped"])
        with capture_first_calls([(pt, "fused_subpixel_deconv"),
                                  (pt, "fused_phase_tail")]) as seen3:
            serve3(pipe.prepare(images[:g]))
    finally:
        pt.SUBPIX_BATCHED = True
    drive("path 4 (float, flip test)", serve_with(pipe4, g, cams_small),
          lambda: pipe4.prepare(views_f32), g, 3, ["decode_heatmaps_kernel"])
    tail5 = ["deconv.fused_subpixel_deconv", "fused_subpixel_deconv_head",
             "decode_heatmaps_kernel"]
    drive(PATH5A, serve5(fwd5a, p5a), make_x5, GROUPS, 9, tail5)
    drive(PATH5B, serve5(fwd5b, p5b), make_x5, GROUPS, 9, ["fused_bottleneck"] + tail5)
    per_forward = {k: v / 9 for k, v in launches_by_path[PATH5B].items() if v}
    check(per_forward == {"fused_bottleneck": 13, "deconv.fused_subpixel_deconv": 2,
                          "fused_subpixel_deconv_head": 1, "decode_heatmaps_kernel": 1},
          f"{PATH5B}: launches per forward {per_forward}")
    with identity_blocks_through_v2():
        drive(PATH5C, serve5(fwd5b, p5b), make_x5, GROUPS, 3,
              ["fused_bottleneck", "fused_bottleneck_v2"] + tail5)
    check(launches_by_path[PATH5C]["fused_bottleneck_v2"] == 12 * 3,
          f"{PATH5C}: launches {launches_by_path[PATH5C]}")
    drive("path 5's input through the int8 runner's forward (no fused kernel)",
          serve5(fwd5, q5), make_x5, GROUPS, 3, ["decode_heatmaps_kernel"])
    drive(PATH6, serve6, prepare6, GROUPS, 9, ["decode_heatmaps_kernel"])
    check(launches_by_path[PATH6]["decode_heatmaps_kernel"] == 9,
          f"{PATH6}: launches {launches_by_path[PATH6]}")

    # the fused forwards against the runner's forward on the card. The
    # kernels' folded, once-rounded epilogues may move an int8 value by one
    # step on rare elements (each block is held to that in phase 4); through
    # 50 layers of random weights such a step spreads, so the heatmaps are
    # close, not equal: within 5 % of their range. A random-weight model's
    # heatmaps are noise-like, with near-tied peaks that so small a change
    # moves: at least half of the joints must still decode within one heatmap
    # pixel (box 500 px over 64) of the runner's, and all of them where only
    # the deconvs are fused (path 5a, whose trunk is the runner's)
    x5_dev = make_x5()
    hm_runner = heatmaps5(fwd5, q5, x5_dev)
    preds_runner, _ = final_preds(hm_runner, center, scale)
    span = float(hm_runner.max() - hm_runner.min())
    for label, fwd, params in ((PATH5A, fwd5a, p5a), (PATH5B, fwd5b, p5b)):
        hm = heatmaps5(fwd, params, x5_dev)
        preds, _ = final_preds(hm, center, scale)
        close = float(((preds - preds_runner).abs().amax(dim=-1) <= 500.0 / 64).float().mean())
        log(f"{label} vs the runner's forward: heatmaps max abs diff "
            f"{float((hm - hm_runner).abs().max())} of a range {span}, "
            f"{float((hm != hm_runner).float().mean()):.4f} of the values differ, "
            f"{close:.4f} of the joints within one heatmap pixel")
        err = float((hm - hm_runner).abs().max())
        check(err <= 0.05 * span, f"{label}: heatmaps differ from the runner's by {err} "
              f"of a range {span}")
        check(close >= (0.99 if label == PATH5A else 0.5),
              f"{label}: only {close:.3f} of the joints agree with the runner's")
    del hm, hm_runner, x5_dev

    # flip_test=True mirrors inside infer: the same bytes, so equal outputs
    p_flip, m_flip = pipe_flip.infer(pipe_pre.params, pipe_flip.prepare(images),
                                     center, scale, is_h36m)
    check(torch.equal(p_flip, p_pre) and torch.equal(m_flip, m_pre),
          "flip_test=True and 'premirrored' differ")
    log("flip_test=True == 'premirrored': preds and maxvals equal")

    # path 1 without the aggregation kernel (the JAX package's XLA route):
    # the plain aggregation's int32 products are exact, so equal outputs
    x_p1 = pipe.prepare(images)
    p_k, m_k = pipe.infer(pipe.params, x_p1, center, scale, is_h36m)
    b3_before = agg.aggregation_grouped.launches
    p_plain, m_plain = pipe_plain.infer(pipe.params, x_p1, center, scale, is_h36m)
    check(agg.aggregation_grouped.launches == b3_before,
          "aggre_kernel=False launched the aggregation kernel")
    check(torch.equal(p_plain, p_k) and torch.equal(m_plain, m_k),
          f"aggre_kernel=False differs from path 1: preds "
          f"{float((p_plain - p_k).abs().max())}, maxvals {float((m_plain - m_k).abs().max())}")
    log("path 1 with aggre_kernel=False (no B3 launch): preds and maxvals equal to path 1's")
    del x_p1

    # where one request's time goes on each path: host packing and upload,
    # then the device by kernel family
    for label, prepare, serve, batched in (
            ("path 1", lambda: pipe.prepare(images), serve_with(pipe), True),
            ("path 2", lambda: pipe_pre.prepare(images), serve_with(pipe_pre), True),
            ("path 3", lambda: pipe.prepare(images[:g]), serve3, False),
            ("path 4", lambda: pipe4.prepare(views_f32),
             serve_with(pipe4, g, cams_small), True),
            ("path 5b", make_x5, serve5(fwd5b, p5b), True),
            ("path 5c", make_x5, serve5(fwd5b, p5b), True),
            ("path 6", prepare6, serve6, True)):
        t = time.perf_counter()
        x = prepare()
        torch.cuda.synchronize()
        prepare_ms = (time.perf_counter() - t) * 1e3
        pt.SUBPIX_BATCHED = batched
        try:
            with identity_blocks_through_v2() if label == "path 5c" else nullcontext():
                prof = profile_request(lambda: serve(x))
        finally:
            pt.SUBPIX_BATCHED = True
        log(f"profile {label}: " + json.dumps({"prepare_ms": prepare_ms, **prof}))
        hand = prof["hand_kernel_launches"]
        tail2 = {k: v for k, v in hand.items() if k.startswith("tail2_kernel")}
        aggs = {k: v for k, v in hand.items() if k.startswith("aggregation")}
        if label in ("path 1", "path 2"):  # B2 and B1 on tail2_kernel; z2 stays on chip
            check(tail2 == {tail2_instance(0, "relu_phase", pt.STREAM_DESIGN, "phase_major"): 1,
                            tail2_instance(0, "relu", "halo", "interleaved"): 1,
                            tail2_instance(2, "relu", "halo", "head_packed2"): 1}
                  and hand.get("quantize_kernel") == 1, f"{label}: hand kernel launches {hand}")
        if label == "path 2":  # B4 on its wgmma kernel, once
            check(aggs == {"aggregation_w4_kernel": 1}, f"path 2: hand kernel launches {hand}")
        if label == "path 3":  # B6 and B5 as tail2_kernel's N-minor and levels=1 instances
            check(tail2 == {tail2_instance(0, "relu_phase", pt.STREAM_DESIGN, "n_minor"): 1,
                            tail2_instance(2, "relu", "halo", "head_packed1"): 1}
                  and aggs == {"aggregation_kernel": 1} and hand.get("quantize_kernel") == 1,
                  f"path 3: hand kernel launches {hand}")
        if label == "path 5b":  # B9a: deconv0 streamed, deconv1 on the halo; B9b on the halo
            rows = sum(v for k, v in hand.items() if k.startswith("bottleneck_rows_kernel"))
            check(tail2 == {tail2_instance(0, "folded", dcv.STREAM_DESIGN, "interleaved"): 1,
                            tail2_instance(0, "folded", "halo", "interleaved"): 1,
                            tail2_instance(2, "folded", "halo", "head_row_major"): 1}
                  and rows == 13 and hand.get("decode_kernel") == 1,
                  f"path 5b: hand kernel launches {hand}")
        if label == "path 5c":  # B8b's wgmma kernel for the 12 identity blocks, B8a for one
            v2 = sum(v for k, v in hand.items() if k.startswith("bottleneck_v2_kernel"))
            rows = sum(v for k, v in hand.items() if k.startswith("bottleneck_rows_kernel"))
            check(v2 == 12 and rows == 1, f"path 5c: hand kernel launches {hand}")
        if label == "path 6":  # B7 decodes the S-minor maps in place, once
            check(hand == {"decode_kernel": 1}, f"path 6: hand kernel launches {hand}")

    # path 7: the bf16 training step at full width, chained through its state
    cfg7 = train_config(50, 256, 64)
    t0 = time.perf_counter()
    model7 = get_multiview_pose_net(cfg7, torch.Generator().manual_seed(7), dtype=torch.bfloat16)
    tx7 = make_optimizer(cfg7, steps_per_epoch=1000)  # 1e-3 throughout (LR_STEP: epoch 90)
    state7 = init_train_state(model7, tx7, device=dev)
    step7 = make_train_step(model7, cfg7, tx7, device=dev)
    batch7 = train_batch(GROUPS, 256, 64, 16, dev, seed=7)
    torch.cuda.synchronize()
    log(f"path 7 model, optimizer state and batch: {time.perf_counter() - t0:.1f} s")
    for name in wrappers:
        wrapper(name).launches = 0
    losses7, events7 = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_timed = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state7, metrics7 = step7(state7, batch7)
        end.record()
        events7.append((start, end))
        losses7.append(metrics7["loss"])
    torch.cuda.synchronize()
    wall7 = time.perf_counter() - t_timed
    counts7 = {k: v for k, v in ((n, wrapper(n).launches) for n in wrappers) if v}
    step_ms = [a.elapsed_time(b) for a, b in events7]
    peak7 = torch.cuda.max_memory_allocated() / 2**30
    losses7 = torch.stack(losses7).float().cpu()
    check(bool(torch.isfinite(losses7).all()), f"path 7: non-finite loss {losses7.tolist()}")
    check(state7.step == TRAIN_WARMUP + TRAIN_STEPS
          and state7.opt_state["count"] == TRAIN_WARMUP + TRAIN_STEPS, "path 7: step count")
    timed = sorted(step_ms[TRAIN_WARMUP:])
    gps = sorted(GROUPS * 1e3 / t for t in timed)
    log(f"path 7 (bf16 training step, R50, {GROUPS} groups of {VIEWS} x 256^2): step ms "
        f"{[round(t, 2) for t in step_ms]} (the first {TRAIN_WARMUP} warm up); groups/s median "
        f"{statistics.median(gps):.2f}, min-max {gps[0]:.2f}-{gps[-1]:.2f}; images/s median "
        f"{VIEWS * statistics.median(gps):.1f}, min-max {VIEWS * gps[0]:.1f}-"
        f"{VIEWS * gps[-1]:.1f}; host clock over the {TRAIN_STEPS} timed steps "
        f"{GROUPS * TRAIN_STEPS / wall7:.2f} groups/s; peak {peak7:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses7.tolist()]}; hand kernel launches {counts7} | {card}")
    prof7 = profile_request(lambda: step7(state7, batch7), TRAIN_FAMILIES)
    check(not prof7["hand_kernel_launches"], f"path 7: hand kernels {prof7['hand_kernel_launches']}")
    log("profile path 7: " + json.dumps(prof7))
    del model7, state7, step7, batch7, tx7, metrics7
    torch.cuda.empty_cache()

    # path 8: the adversarial step at full width (f32, TF32 convolutions as
    # PyTorch's default), parity 0 and 1 in turn, chained through the states
    def gan_states(cfg_, seed, device):
        gen = torch.Generator().manual_seed(seed)
        net = get_multiview_pose_net(cfg_, gen)
        critics = build_discriminators(cfg_, gen)
        tx_ = make_optimizer(cfg_, steps_per_epoch=1000)
        tx_d = {n: make_optimizer(cfg_, steps_per_epoch=1000, discriminator=True)
                for n in critics}
        states = {"base_model": init_train_state(net, tx_, device=device),
                  **init_discriminator_states(critics, tx_d, device=device)}
        return states, make_adversarial_train_step(net, critics, cfg_, tx_, tx_d,
                                                   device=device, seed=seed)

    cfg8 = gan_config(50, 256, 64)
    t0 = time.perf_counter()
    states8, step8 = gan_states(cfg8, 9, dev)
    batch8 = gan_batch(GAN_GROUPS, 256, 64, 16, dev, seed=9)
    torch.cuda.synchronize()
    log(f"path 8 model, critics, optimizer states and batch: {time.perf_counter() - t0:.1f} s")
    for name in wrappers:
        wrapper(name).launches = 0
    losses8, events8 = [], {0: [], 1: []}
    n_steps = GAN_WARMUP + 2 * GAN_STEPS
    for i in range(n_steps):
        if i == GAN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        parity = i % 2
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        states8, metrics8 = step8(states8, batch8, parity)
        end.record()
        if i >= GAN_WARMUP:
            events8[parity].append((start, end))
        losses8.append(torch.stack([v.float() for k, v in metrics8.items() if k != "acc"]))
    torch.cuda.synchronize()
    counts8 = {k: v for k, v in ((n, wrapper(n).launches) for n in wrappers) if v}
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    check(all(bool(torch.isfinite(v).all()) for v in losses8), "path 8: a non-finite loss")
    check(all(st.step == n_steps and st.opt_state["count"] == n_steps
              for st in states8.values()),
          f"path 8: step counts "
          f"{ {n: (st.step, st.opt_state['count']) for n, st in states8.items()} }")
    check(not counts8, f"path 8: hand kernel launches {counts8}")
    rates8 = {}
    for parity in (0, 1):
        ms = sorted(a.elapsed_time(b) for a, b in events8[parity])
        gps = sorted(GAN_GROUPS * 1e3 / t for t in ms)
        rates8[parity] = (statistics.median(gps), gps[0], gps[-1], ms)
    log(f"path 8 (adversarial step, f32 R50, {GAN_GROUPS} groups of {VIEWS} x 256^2, five "
        f"critics + fundamental loss; {GAN_WARMUP} warm-up steps, then {GAN_STEPS} of each "
        f"parity in turn): " + "; ".join(
            f"parity {p}: groups/s median {r[0]:.2f}, min-max {r[1]:.2f}-{r[2]:.2f} (step ms "
            f"{[round(t, 2) for t in r[3]]})" for p, r in rates8.items())
        + f"; peak {peak8:.2f} GiB; last metrics "
        f"{ {k: round(float(v), 4) for k, v in metrics8.items()} } | {card}")
    for parity in (0, 1):
        prof8 = profile_request(lambda: step8(states8, batch8, parity), GAN_FAMILIES)
        check(not prof8["hand_kernel_launches"],
              f"path 8: hand kernels {prof8['hand_kernel_launches']}")
        log(f"profile path 8, parity {parity}: " + json.dumps(prof8))
    del states8, step8, batch8, metrics8, losses8
    torch.cuda.empty_cache()

    # path 9: the 3D and pseudo-label stages at full width (path9)
    def reset_counts():
        for name in wrappers:
            wrapper(name).launches = 0

    line9, checks9 = path9(dev, reset_counts,
                           lambda: {name: wrapper(name).launches for name in wrappers})
    launches9 = line9["launches"]
    check(launches9 == {"decode_heatmaps_kernel": G9 * VIEWS // RENDER_CHUNK},
          f"{PATH9}: hand kernel launches {launches9}")
    log(f"{PATH9}: " + json.dumps(line9) + f" | {card}")
    torch.cuda.empty_cache()

    # path 10: the train CLI on images (path10); path 11: serving its
    # checkpoint and a converted reference one (path11), on its fixture
    read_counts = lambda: {name: wrapper(name).launches for name in wrappers}  # noqa: E731
    tmp = tempfile.mkdtemp(prefix="posetpu-path10-")
    try:
        t0 = time.perf_counter()
        seen10 = path10(tmp, dev, reset_counts, read_counts, card)
        log(f"{PATH10}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        seen11 = path11(tmp, seen10["final_state"], dev, reset_counts, read_counts, card)
        log(f"{PATH11}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # one more request per path to take each kernel's inputs for phase 4 (the
    # callers look the kernels up on their modules at call time)
    with capture_first_calls([(pt, "fused_subpixel_deconv_batched"),
                              (pt, "fused_phase_tail2"),
                              (agg, "aggregation_grouped"),
                              (agg, "quantize_heatmaps")]) as seen:
        serve_with(pipe)(pipe.prepare(images))
    with capture_first_calls([(agg, "aggregation_grouped_s4"),
                              (pt, "fused_subpixel_deconv_batched")]) as seen2:
        serve_with(pipe_pre)(pipe_pre.prepare(images))
    b2_path2 = seen2.pop("fused_subpixel_deconv_batched")
    with capture_first_calls([(dec, "decode_heatmaps_kernel")]) as seen4:
        serve_with(pipe4, g, cams_small)(pipe4.prepare(views_f32))
    with capture_first_calls([(dec, "decode_heatmaps_kernel")]) as seen9:
        checks9.pop("decode_first_chunk")()
    seen.update(seen2)
    seen.update(seen3)
    seen.update(seen4)
    with capture_first_calls([(rb, "fused_bottleneck"), (dcv, "fused_subpixel_deconv"),
                              (dcv, "fused_subpixel_deconv_head"),
                              (dec, "decode_heatmaps_kernel")], every=True) as seen5:
        serve5(fwd5b, p5b)(make_x5())
    reached = set(seen) | {"deconv." + k if k == "fused_subpixel_deconv" else k
                           for k in seen5} | {"fused_bottleneck_v2"}
    check(reached == set(wrappers), f"kernels not reached on their paths: "
          f"{set(wrappers) - reached}")
    check([len(seen5[k]) for k in ("fused_bottleneck", "fused_subpixel_deconv",
                                   "fused_subpixel_deconv_head")] == [13, 2, 1],
          "path 5b: calls per forward")

    # ------------------------------------------------------------ 4. kernels
    results = []
    home = {"fused_subpixel_deconv_batched": "path 1 (defaults)",
            "fused_phase_tail2": "path 1 (defaults)",
            "aggregation_grouped": "path 1 (defaults)",
            "quantize_heatmaps": "path 1 (defaults)",
            "aggregation_grouped_s4": "path 2 (premirrored flip, s4 bank)",
            "fused_phase_tail": "path 3 (one-level tail, per-pair deconv0)",
            "fused_subpixel_deconv": "path 3 (one-level tail, per-pair deconv0)",
            "decode_heatmaps_kernel": "path 4 (float, flip test)",
            "fused_bottleneck": PATH5B, "fused_bottleneck_v2": PATH5C,
            "deconv.fused_subpixel_deconv": PATH5B, "fused_subpixel_deconv_head": PATH5B}

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def compare_cases(name, source, replaces, plain, cases, library=None,
                      peak_ops=PEAK_INT8_OPS, also=None, headline=None, note=None,
                      extra=None):
        """One kernel on each of ``cases`` [(tag, args, kw, operations,
        bytes)]: equal to its plain version on every one. Its time, the plain
        version's and the bound are sums over the cases (one forward's
        worth), or those of case number ``headline`` alone. ``library``: one
        yardstick call, or {tag: call} with one per case.
        ``also(tag, out, args, kw)``: a further check of the output;
        ``note(args, kw)``: more to say on a case's line."""
        err, per_case = 0.0, []
        total = {"ms": 0.0, "plain_ms": 0.0, "operations": 0.0, "bytes": 0.0}
        for tag, args, kw, ops, nbytes_ in cases:
            kernel = lambda: wrapper(name)(*args, **kw)
            ref_fn = lambda: plain(*args, **kw)
            got, ref = as_tuple(kernel()), as_tuple(ref_fn())
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                check(a.dtype == b.dtype and a.shape == b.shape, f"{name}{tag}: shape/dtype")
                err = max(err, float((a.double() - b.double()).abs().max()))
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"{name}{tag}: kernel != plain (max abs err {err})")
            if also is not None:
                also(tag, got[0], args, kw)
            del got, ref
            ms, plain_ms = cuda_ms(kernel), cuda_ms(ref_fn)
            b_ms, b_by = bound(ops, nbytes_, peak_ops)
            case = {"case": tag.strip(), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
            if isinstance(library, dict):
                case["library_ms"] = cuda_ms(library[tag])
            if headline is None or headline == len(per_case):
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total[b_by] += b_ms
            per_case.append(case)
            if len(cases) > 1:
                log(f"kernel {name}{tag}: equal to plain, {ms:.4f} ms (plain "
                    f"{plain_ms:.4f}, bound {b_ms:.4f} by {b_by}"
                    + (f", library {case['library_ms']:.4f}" if "library_ms" in case else "")
                    + ")" + (f"; {note(args, kw)}" if note is not None else ""))
        if isinstance(library, dict):
            lib_ms = (sum(c["library_ms"] for c in per_case) if headline is None
                      else per_case[headline]["library_ms"])
        else:
            lib_ms = None if library is None else cuda_ms(library)
        b_ms = total["operations"] + total["bytes"]
        b_by = "operations" if total["operations"] >= total["bytes"] else "bytes"
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches_by_path[home[name]][name],
                        "path": home[name], "max_abs_err": err, "ms": total["ms"],
                        "plain_ms": total["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms,
                        **({"cases": per_case} if len(cases) > 1 else {}),
                        **(extra or {})})
        log(f"kernel {name}: equal to plain, {total['ms']:.4f} ms (plain "
            f"{total['plain_ms']:.4f}, library {lib_ms}, bound {b_ms:.4f} by {b_by}"
            + "".join(f", {k} {v:.4f}" for k, v in (extra or {}).items()) + f") | {card}")

    def compare(name, source, replaces, plain, args, kw, ops, nbytes_, library=None,
                peak_ops=PEAK_INT8_OPS, extra=None):
        compare_cases(name, source, replaces, plain, [("", args, kw, ops, nbytes_)],
                      library, peak_ops, extra=extra)

    def subpixel_work(x0, a0):
        n, hw, cin = x0.shape
        cout = a0["w"].shape[2]
        return 2 * 16 * n * hw * cout * cin, nbytes(x0, a0) + 4 * n * hw * cout

    def x4_of(x, kw):
        return x.reshape(x.shape[0], kw["h"], kw["w"], x.shape[-1])

    # B2 at path 1's 128 images (the kernels line's numbers) and path 2's 256;
    # each weight counts once: the kernel reads the stage images and svb
    def b2_case(tag, args, kw):
        x, a = args
        once = {k: v for k, v in a.items() if k not in ("wt", "svb")}
        return (f" {tag}, {x.shape[0]} images", args, kw, *subpixel_work(x, once))

    def b2_plan(args, kw):
        x, a = args
        sets = pt.stream_sets(x.shape[0], kw["h"], kw["w"], a["svb"].shape[-1], pt.sm_count(0))
        return f"{sets} (phase, n-half) pairs a block, ring {pt.STREAM_STAGES}"

    b2_cases = [b2_case("path 1", *seen["fused_subpixel_deconv_batched"]),
                b2_case("path 2", *b2_path2)]
    check(b2_cases[0][0].endswith(" 128 images") and b2_cases[1][0].endswith(" 256 images"),
          f"B2's cases: {[c[0] for c in b2_cases]}")
    compare_cases("fused_subpixel_deconv_batched", "posetpu_torch/csrc/tail2.cu",
                  "posetpu/ops/pallas/phase_tail.py:609", pt.subpixel_deconv_plain, b2_cases,
                  library={tag: phase_gemms(x4_of(a[0], kw), a[1]["w"])
                           for tag, a, kw, _, _ in b2_cases},
                  headline=0, note=b2_plan)
    del b2_cases, b2_path2

    (x1, a1), kw1 = seen["fused_phase_tail2"]
    n, hw, cin = x1.shape
    cmid, cout, joints = a1["w1"].shape[2], a1["w2"].shape[2], a1["wh"].shape[0]
    macs1 = (16 * n * hw * cmid * cin + 16 * n * 4 * hw * cout * cmid
             + n * 16 * hw * joints * cout)

    # each weight counts once: the kernel reads the stage images (w1t, w2t, wht).
    # Its yardstick: deconv1's phase GEMMs on x, deconv2's on z1 and the
    # head's on z2 (both the plain version's, gathered beforehand)
    once1 = {k: v for k, v in a1.items() if not k.endswith("t")}
    x14 = x4_of(x1, kw1)
    z1_lib = pt._phase_conv_plain(x14, a1["w1"], a1["s1"][0], a1["s1"][1], a1["so1"],
                                  interleave=True)
    z2_lib = pt._phase_conv_plain(z1_lib, a1["w2"], a1["s2"][0], a1["s2"][1], a1["so2"],
                                  interleave=False)
    lib1 = {"deconv1": phase_gemms(x14, a1["w1"]),
            "deconv2 + head": phase_gemms(z1_lib, a1["w2"], z2_lib, a1["wh"])}
    del z2_lib
    compare("fused_phase_tail2", "posetpu_torch/csrc/tail2.cu",
            "posetpu/ops/pallas/phase_tail.py:384", pt.phase_tail2_plain,
            (x1, a1), kw1, 2 * macs1, nbytes(x1, once1) + 4 * joints * n * 16 * hw,
            library=lambda: [f() for f in lib1.values()])
    log("kernel fused_phase_tail2: library by launch: " + ", ".join(
        f"{k} {cuda_ms(f):.4f} ms" for k, f in lib1.items()) + f" | {card}")
    del lib1, z1_lib

    def gathered_operands(qagg, hm, bank_ok):
        """The library yardstick's operands: per target one int8 GEMM
        [JN, 3S] x [3S, S], gathered beforehand (not timed); ``bank_ok``
        [4, 3, S_out, S_in] int8."""
        s = hm.shape[-1]
        xq = agg._quantize(qagg, hm)
        gathered = [torch.cat([xq[p] for p in range(4) if p != t], dim=1) for t in range(4)]
        bank_kn = [bank_ok[t].transpose(-1, -2).reshape(3 * s, s).contiguous()
                   for t in range(4)]
        return lambda: [torch._int_mm(gathered[t], bank_kn[t]) for t in range(4)]

    (qagg, hm), kw3 = seen["aggregation_grouped"]
    j, ng, v, s = hm.shape
    xq3 = agg.quantize_heatmaps(qagg, hm)
    out3 = torch.empty((4, j * ng, s), dtype=torch.float32, device=dev)
    lib3 = _build.load("aggregation", agg._SIGNATURES)

    def b3_gemm_alone():  # the GEMM kernel on the quantised planes, no wrapper
        _build.check(lib3.aggregation_grouped(xq3.data_ptr(), qagg["wq"].data_ptr(),
                                              qagg["sv"].data_ptr(), out3.data_ptr(), j * ng,
                                              s, pt.stream_of(hm)), "aggregation_grouped")
    compare("aggregation_grouped", "posetpu_torch/csrc/aggregation.cu",
            "posetpu/ops/pallas/aggregation.py:148", agg.aggregation_grouped_plain,
            (qagg, hm), kw3, 2 * 4 * j * ng * 3 * s * s, nbytes(hm, qagg) + hm.numel() * 4,
            library=gathered_operands(qagg, hm, qagg["wq"]),
            extra={"kernel_ms": cuda_ms(b3_gemm_alone)})
    del xq3, out3

    # B3's quantize pass: f32 in, int8 out, a multiply, a round and a clip
    # per value outside the tensor cores
    (qaggq, hmq), kwq = seen["quantize_heatmaps"]
    compare("quantize_heatmaps", "posetpu_torch/csrc/aggregation.cu",
            "posetpu/ops/pallas/aggregation.py:184", agg._quantize, (qaggq, hmq), kwq,
            3 * hmq.numel(), hmq.numel() * 5 + 4, peak_ops=PEAK_F32_OPS)

    # B4: the bank counts at half a byte per weight (its tensor is uint8
    # [4, 3, S, S/2]); the diagonal term adds 3 multiply-adds per output
    (qagg4, hm4), kw4 = seen["aggregation_grouped_s4"]
    j, ng, v, s = hm4.shape
    xq4 = agg.quantize_heatmaps(qagg4, hm4)
    out4 = torch.empty((4, j * ng, s), dtype=torch.float32, device=dev)

    def b4_gemm_alone():  # the B4 kernel on the quantised planes, no wrapper
        _build.check(lib3.aggregation_grouped_s4(
            xq4.data_ptr(), qagg4["wq4"].data_ptr(), qagg4["sv"].data_ptr(),
            qagg4["dv"].data_ptr(), out4.data_ptr(), j * ng, s, agg.S4_STAGES,
            pt.stream_of(hm4)),
            "aggregation_grouped_s4")
    compare("aggregation_grouped_s4", "posetpu_torch/csrc/aggregation.cu",
            "posetpu/ops/pallas/aggregation.py:294", agg.aggregation_grouped_s4_plain,
            (qagg4, hm4), kw4, 2 * 4 * j * ng * 3 * s * s,
            nbytes(hm4, {k: v for k, v in qagg4.items() if k != "sv"}) + hm4.numel() * 4,
            library=gathered_operands(qagg4, hm4, agg.unpack_nibbles_k(qagg4["wq4"])),
            extra={"kernel_ms": cuda_ms(b4_gemm_alone)})
    del xq4, out4

    # B5 at path 3's 32 images (the kernels line's numbers) and on the same
    # input four times over, 128 images of B9b's shape (B9b is timed below);
    # each weight counts once: the kernel reads the stage images (wt, wht)
    (x5, a5), kw5 = seen["fused_phase_tail"]
    once5 = {k: v for k, v in a5.items() if k not in ("wt", "wht")}

    def b5_case(tag, x):
        n, hw, cin = x.shape
        cout, joints = a5["w"].shape[2], a5["wh"].shape[0]
        return (f" {tag}, {n} images", (x, a5), kw5,
                2 * (16 * n * hw * cout * cin + n * 4 * hw * joints * cout),
                nbytes(x, once5) + 4 * joints * n * 4 * hw)

    def b5_library(x):
        z = pt._phase_conv_plain(x4_of(x, kw5), a5["w"], a5["sv"][0], a5["sv"][1], a5["so"],
                                 interleave=False)
        return phase_gemms(x4_of(x, kw5), a5["w"], z, a5["wh"])

    b5_cases = [b5_case("path 3", x5), b5_case("path 3's input x4", x5.repeat(4, 1, 1))]
    check(b5_cases[0][0].endswith(" 32 images") and b5_cases[1][0].endswith(" 128 images"),
          f"B5's cases: {[c[0] for c in b5_cases]}")
    compare_cases("fused_phase_tail", "posetpu_torch/csrc/tail2.cu",
                  "posetpu/ops/pallas/phase_tail.py:184", pt.phase_tail_plain, b5_cases,
                  library={tag: b5_library(a[0]) for tag, a, _, _, _ in b5_cases}, headline=0)
    b5_128_ms = results[-1]["cases"][1]["ms"]
    del b5_cases

    # B6 at path 3's 32 images (the kernels line's numbers) and on B2's
    # 128-image input from path 1, timed beside B2 there
    def b6_case(tag, args, kw):
        x, a = args
        once = {k: v for k, v in a.items() if k not in ("wt", "svb")}
        return (f" {tag}, {x.shape[0]} images", args, kw, *subpixel_work(x, once))

    b6_cases = [b6_case("path 3", *seen["fused_subpixel_deconv"]),
                b6_case("B2's input from path 1", *seen["fused_subpixel_deconv_batched"])]
    check(b6_cases[0][0].endswith(" 32 images") and b6_cases[1][0].endswith(" 128 images"),
          f"B6's cases: {[c[0] for c in b6_cases]}")
    (x2, a2), kw2 = seen["fused_subpixel_deconv_batched"]
    compare_cases("fused_subpixel_deconv", "posetpu_torch/csrc/tail2.cu",
                  "posetpu/ops/pallas/phase_tail.py:527", pt.subpixel_deconv_pairs_plain,
                  b6_cases, library={tag: phase_gemms(x4_of(a[0], kw), a[1]["w"])
                                     for tag, a, kw, _, _ in b6_cases},
                  headline=0, note=b2_plan,
                  extra={"b2_ms_same_input": cuda_ms(
                      lambda: pt.fused_subpixel_deconv_batched(x2, a2, **kw2))})
    del b6_cases

    # B7: one compare and one select per element, outside the tensor cores;
    # every map read once, 12 bytes written per map. At path 4's 512 maps
    # (the kernels line's numbers), at path 5's 2,048 and at path 9's 65,536
    # (one render chunk), each beside torch.max over the same maps flattened
    def decode_case(tag, hm, kw):
        maps = hm.numel() // (hm.shape[-1] * hm.shape[-2])
        return (f" {tag}, {maps} maps", (hm,), kw, 2 * hm.numel(), nbytes(hm) + 12 * maps)

    (hm7,), kw7 = seen["decode_heatmaps_kernel"]
    (hm7b,), kw7b = seen5["decode_heatmaps_kernel"][0]
    (hm7c,), kw7c = seen9["decode_heatmaps_kernel"]
    decode_cases = [decode_case("path 4", hm7, kw7), decode_case("path 5b", hm7b, kw7b),
                    decode_case("path 9", hm7c, kw7c)]
    decode_cases += [decode_case(f"path 10 {step} (validate)", args[0], kw)
                     for step, (args, kw) in seen10["b7"].items()]
    decode_cases.append(decode_case("path 11 (int8 validate)", seen11["b7"][0][0],
                                    seen11["b7"][1]))
    check([c[0].split(", ")[1] for c in decode_cases]
          == ["512 maps", "2048 maps", f"{RENDER_CHUNK * 16} maps", "512 maps", "512 maps",
              "512 maps"], f"B7's cases: {[c[0] for c in decode_cases]}")
    # the yardstick takes what the wrapper takes: path 4 hands over a permuted
    # view, which either has to copy before it can read a map as one row
    def flat_max(hm):
        return lambda: torch.max(hm.reshape(-1, hm.shape[-2] * hm.shape[-1]), dim=-1)

    compare_cases("decode_heatmaps_kernel", "posetpu_torch/csrc/decode.cu",
                  "posetpu/ops/pallas/decode.py:61", decode_heatmaps, decode_cases,
                  library={c[0]: flat_max(c[1][0]) for c in decode_cases},
                  peak_ops=PEAK_F32_OPS, headline=0)
    results[-1]["launches_path9"] = launches9["decode_heatmaps_kernel"]
    results[-1]["launches_path10"] = seen10["launches"]
    results[-1]["launches_path11"] = seen11["launches"]

    # B7's wrapper on the host: per call with the launch, with the launch
    # stubbed out (what the Python around the kernel costs), and torch.max's
    def host_us(fn, reps=2000):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t) / reps * 1e6
        torch.cuda.synchronize()
        return us

    # (paths 4 and 5b: path 9's maps are large enough that the queue of
    # launches fills and the host waits on the card)
    for (tag, (hm,), kw, _, _) in decode_cases[:2]:
        with_launch = host_us(lambda: dec.decode_heatmaps_kernel(hm, **kw))
        real_kernel, dec._kernel = dec._kernel, lambda *a: 0
        try:
            stubbed = host_us(lambda: dec.decode_heatmaps_kernel(hm, **kw))
        finally:
            dec._kernel = real_kernel
        log(f"B7 wrapper on the host,{tag}: {with_launch:.2f} us a call, {stubbed:.2f} us with "
            f"the launch stubbed out; torch.max on the same input {host_us(flat_max(hm)):.2f} us; "
            f"input contiguous f32 (no copy first): "
            f"{hm.is_contiguous() and hm.dtype == torch.float32} | {card}")
    del decode_cases, hm7c, seen9, seen10
    seen11.pop("b7")

    # B8a on each of path 5b's 13 block inputs, and each block within one
    # int8 step of the runner's block on the same input (the folded,
    # once-rounded epilogues may move a value by one step on < 1e-3 of them)
    infos = {info["name"]: info for kind, info in quant._plan(50, (4, 4, 4)) if kind == "block"}
    order = list(infos)
    runner5 = quant._Int8Runner(q5)

    def block_work(x, a):
        n, hw, cin = x.shape
        cm, cout = a["w1"].shape[0], a["w3"].shape[0]
        macs = n * hw * (cin * cm + 9 * cm * cm + cm * cout + (cin * cout if "wd" in a else 0))
        # each weight counts once: B8a reads the tiled copies (w1t, ...) of the K-minor ones
        once = {k: v for k, v in a.items() if not k.endswith("t")}
        return 2 * macs, nbytes(x, once) + n * hw * cout

    def within_one_step_of_the_runner(tag, out, args, kw):
        name = tag.strip()
        prev = order[order.index(name) - 1] if order.index(name) else "stem"
        x4 = args[0].reshape(args[0].shape[0], kw["h"], kw["w"], -1)
        ref, _ = quant._run_block(runner5, x4, q5["act_scales"][f"{prev}.out"], infos[name])
        d = (out.reshape(ref.shape).int() - ref.int()).abs()
        share = float((d > 0).float().mean())
        check(int(d.max()) <= 1 and share < 1e-3,
              f"fused block {name} vs the runner's: max step {int(d.max())}, share {share}")
        log(f"fused block {name} vs the runner's block on the same input: max step "
            f"{int(d.max())}, {share:.2e} of the values differ")

    def block_gemms(x, a, kw):
        """The fused block's library yardstick: one ``torch._int_mm`` each for
        conv1 on x, conv2 on the im2col patches of h1, conv3 on h2 and the
        projection on x where there is one, operands gathered beforehand (h1
        and h2 the plain version's): the GEMMs alone."""
        n, hw, cin = x.shape
        cm = a["w1"].shape[0]
        x2 = x.reshape(n * hw, cin)
        h1 = rb._requant(torch._int_mm(x2, a["w1"].t().contiguous()), a["v1"])
        patches = torch.cat(rb._taps(h1.reshape(n, kw["h"], kw["w"], cm)), dim=1).contiguous()
        h2 = rb._requant(torch._int_mm(patches, a["w2"].t().contiguous()), a["v2"])
        ops = [(x2, a["w1"]), (patches, a["w2"]), (h2, a["w3"])] + (
            [(x2, a["wd"])] if "wd" in a else [])
        ops = [(m, wk.t().contiguous()) for m, wk in ops]
        return lambda: [torch._int_mm(m, wk) for m, wk in ops]

    block_cases = [(f" {name}", a, kw, *block_work(a[0], a[1]))
                   for name, (a, kw) in zip(blocks5, seen5["fused_bottleneck"])]
    regs = kernel_registers(_build.build_log("resblock"), "bottleneck_rows_kernel")

    def block_shape(args, kw):
        """The block shape B8a's planner gives this layer."""
        x, a = args
        cm, cout = a["w1"].shape[0], a["w3"].shape[0]
        plan = rb.plan_rows(kw["h"], kw["w"], x.shape[2], cm, cout, "wd" in a)
        return (f"th {plan.th}, {rb.RING_STAGES} stages of {rb.RING_K} bytes, "
                f"{plan.ns} staging tiles, {plan.smem} bytes of shared memory, "
                f"{rb.rows_blocks_per_sm(cm, plan.smem)} block(s) per SM, "
                f"{regs['narrow' if cm <= 64 else 'wide']} registers, grid "
                f"{-(-kw['h'] // plan.th)} x {x.shape[0]}")

    compare_cases("fused_bottleneck", "posetpu_torch/csrc/resblock.cu",
                  "posetpu/ops/pallas/resblock.py:157", rb.bottleneck_plain, block_cases,
                  library={tag: block_gemms(a[0], a[1], kw) for tag, a, kw, _, _ in block_cases},
                  also=within_one_step_of_the_runner, note=block_shape)
    b8a_cases = {c["case"]: c for c in results[-1]["cases"]}

    def v2_shape(args, kw):
        """The block B8b's planner gives this layer."""
        x, a = args
        cm = a["w1"].shape[0]
        plan = rb.plan_v2(kw["h"], kw["w"], x.shape[2], cm, a["w3"].shape[0])
        return (f"form {plan.form}, ring {plan.stages} stages of {plan.ips} image(s), "
                f"{plan.smem} bytes of shared memory, {rb.v2_blocks_per_sm(plan, cm)} block(s) "
                f"per SM, {plan.tiles_x * plan.tiles_y * x.shape[0]} jobs")

    # B8b on the 12 identity blocks' inputs, imgs=2: also equal to B8a's output
    v2_cases = [(tag, a, {**kw, "imgs": 2}, ops, nb)
                for tag, a, kw, ops, nb in block_cases if "wd" not in a[1]]
    compare_cases("fused_bottleneck_v2", "posetpu_torch/csrc/resblock.cu",
                  "posetpu/ops/pallas/resblock.py:269", rb.bottleneck_v2_plain, v2_cases,
                  library={tag: block_gemms(a[0], a[1], kw) for tag, a, kw, _, _ in v2_cases},
                  also=lambda tag, out, a, kw: check(
                      torch.equal(out, rb.fused_bottleneck(*a, h=kw["h"], w=kw["w"])),
                      f"fused_bottleneck_v2{tag}: differs from fused_bottleneck"),
                  note=v2_shape)
    # per layer on the same inputs: B8b, B8a and the yardstick, summed over
    # the layer's identity blocks (from the two compares above)
    layers = {}
    for c in results[-1]["cases"]:
        a_case = b8a_cases[c["case"]]
        tot = layers.setdefault(c["case"].split("_")[0], [0, 0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, c["ms"], a_case["ms"], c["library_ms"], c["bound_ms"]), 0):
            tot[i] += v
    for layer, (nb, v2_ms, rows_ms, lib_ms, b_ms) in layers.items():
        log(f"bottleneck {layer}, {nb} identity block(s): B8b {v2_ms:.4f} ms, B8a "
            f"{rows_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"(a block: B8b {v2_ms / nb:.4f}, B8a {rows_ms / nb:.4f}) | {card}")
    del v2_cases, b8a_cases

    def deconv_work(x, a, joints=0):
        n, hw, cin = x.shape
        cout = a["w"].shape[2]
        out_bytes = 4 * n * hw * (4 * joints if joints else cout)
        # each weight counts once: the kernel reads the stage images (wt, wht)
        once = {k: v for k, v in a.items() if k not in ("wt", "wht")}
        return (2 * n * hw * (16 * cin * cout + 4 * joints * cout),
                nbytes(x, once) + out_bytes)

    def deconv_design(args, kw):
        x, a = args
        _, _, cout, cin = a["w"].shape
        d = dcv.deconv_design(cin, cout, a["wh"].shape[0] if "wh" in a else 0)
        stream = d != "halo"
        plan = pt.plan_tail2(kw["h"], kw["w"], cin, cout, 2 if "wh" in a else 0,
                             dcv.STREAM_STAGES if stream else None, design=d, folded=True,
                             sets=pt.stream_sets(x.shape[0], kw["h"], kw["w"], cout,
                                                 pt.sm_count(0)) if stream else None)
        return (f"design {d}, {plan.stages} ring stages, {plan.sets} (phase, n-half) pairs a "
                f"block, {plan.smem} bytes of shared memory")

    cases9a = [(f" deconv{i}", a, kw, *deconv_work(a[0], a[1]))
               for i, (a, kw) in enumerate(seen5["fused_subpixel_deconv"])]
    compare_cases("deconv.fused_subpixel_deconv", "posetpu_torch/csrc/tail2.cu",
                  "posetpu/ops/pallas/deconv.py:122", dcv.subpixel_deconv_plain, cases9a,
                  library={tag: phase_gemms(x4_of(a[0], kw), a[1]["w"])
                           for tag, a, kw, _, _ in cases9a},
                  note=deconv_design)
    (x9, a9), kw9 = seen5["fused_subpixel_deconv_head"][0]
    z9 = dcv.subpixel_deconv_plain(x9, a9, **kw9)
    compare("fused_subpixel_deconv_head", "posetpu_torch/csrc/tail2.cu",
            "posetpu/ops/pallas/deconv.py:151", dcv.subpixel_deconv_head_plain,
            (x9, a9), kw9, *deconv_work(x9, a9, joints=a9["wh"].shape[0]),
            library=phase_gemms(x4_of(x9, kw9), a9["w"], z9, a9["wh"]))
    log(f"kernel fused_subpixel_deconv_head: {deconv_design((x9, a9), kw9)}")
    log(f"B5 at 128 images {b5_128_ms:.4f} ms beside B9b on its shape "
        f"({x9.shape[0]} images) {results[-1]['ms']:.4f} ms | {card}")
    del z9, cases9a
    del seen5, block_cases

    # ------------------------------------------------------------ 5. card vs CPU
    one = images[:1]
    x_cpu = pack_hwcn(torch.from_numpy(one.reshape(VIEWS, 256, 256, 3)))
    to_cpu = lambda t: ({k: to_cpu(u) for k, u in t.items()} if isinstance(t, dict)
                        else [to_cpu(u) for u in t] if isinstance(t, list)
                        else None if t is None else t.cpu())
    args_gpu = (center[:1], scale[:1], is_h36m[:1])
    args_cpu = [a.cpu() for a in args_gpu]
    for label, p, x1_cpu in (
            ("path 1", pipe, x_cpu),
            ("path 2 (s4 bank)", pipe_pre,
             torch.cat([x_cpu, quant.mirror_s2d_hwcn(x_cpu)], dim=3))):
        p_gpu, m_gpu = p.infer(p.params, x1_cpu.to(dev), *args_gpu)
        t = time.perf_counter()
        p_cpu, m_cpu = p.infer(to_cpu(p.params), x1_cpu, *args_cpu)
        check(torch.equal(m_gpu.cpu(), m_cpu), f"card vs CPU, {label}: maxvals differ "
              f"(max {float((m_gpu.cpu() - m_cpu).abs().max())})")
        perr = float((p_gpu.cpu() - p_cpu).abs().max())
        check(perr <= 1e-4, f"card vs CPU, {label}: preds differ by {perr}")
        log(f"card vs CPU on one group, {label}: maxvals equal, preds max abs diff "
            f"{perr} (CPU run {time.perf_counter() - t:.1f} s)")

    v1 = pipe4.prepare(views_f32[:1])
    p_gpu, m_gpu = pipe4.infer(pipe4.params, v1, *args_gpu)
    t = time.perf_counter()
    pipe4_cpu = build_float_pipeline(cfg, model, flip_test=True, device="cpu")
    p_cpu, m_cpu = pipe4_cpu.infer(pipe4_cpu.params, v1.cpu(), *args_cpu)
    merr = float((m_gpu.cpu() - m_cpu).abs().max())
    same = float(((p_gpu.cpu() - p_cpu).abs().amax(dim=-1) <= 1e-3).float().mean())
    check(merr <= 1e-3, f"card vs CPU, path 4: maxvals differ by {merr}")
    check(same >= 0.9, f"card vs CPU, path 4: only {same:.3f} of the joints agree")
    log(f"card vs CPU on one group, path 4: maxvals max abs diff {merr}, "
        f"{same:.3f} of the joints within 1e-3 px (CPU run "
        f"{time.perf_counter() - t:.1f} s)")

    x1 = torch.from_numpy(frames5[:VIEWS])
    hm_gpu = fwd5b(p5b, x1.to(dev)).cpu()
    t = time.perf_counter()
    hm_cpu = fwd5b(to_cpu(p5b), x1)
    check(torch.equal(hm_gpu, hm_cpu), f"card vs CPU, path 5b: heatmaps differ "
          f"(max {float((hm_gpu - hm_cpu).abs().max())})")
    log(f"card vs CPU on one group, path 5b: heatmaps equal "
        f"(CPU run {time.perf_counter() - t:.1f} s)")

    x6 = torch.from_numpy(images[:1].reshape(VIEWS, 256, 256, 3))
    p_gpu, m_gpu = infer6(q6, qagg6, x6.to(dev), *args_gpu)
    t = time.perf_counter()
    p_cpu, m_cpu = infer6(to_cpu(q6), to_cpu(qagg6), x6, *args_cpu)
    check(torch.equal(m_gpu.cpu(), m_cpu), f"card vs CPU, path 6: maxvals differ "
          f"(max {float((m_gpu.cpu() - m_cpu).abs().max())})")
    perr = float((p_gpu.cpu() - p_cpu).abs().max())
    check(perr <= 1e-4, f"card vs CPU, path 6: preds differ by {perr}")
    log(f"card vs CPU on one group, path 6: maxvals equal, preds max abs diff {perr} "
        f"(CPU run {time.perf_counter() - t:.1f} s)")

    # path 7's step in f32 on a small model, the same weights and batch on
    # both; TF32 off on the card, as the CPU computes
    cfg_s = train_config(18, 64, 16)
    model_s = get_multiview_pose_net(cfg_s, torch.Generator().manual_seed(8))
    batch_s = train_batch(2, 64, 16, 16, "cpu", seed=8)
    stepped = {}
    t = time.perf_counter()
    for device in (dev, torch.device("cpu")):
        net = copy.deepcopy(model_s)
        tx_s = make_optimizer(cfg_s, steps_per_epoch=1000)
        st = init_train_state(net, tx_s, device=device)
        with quant._full_fp32():
            _, m_s = make_train_step(net, cfg_s, tx_s, device=device)(st, batch_s)
        stepped[device.type] = ({k: float(v) for k, v in m_s.items()},
                                {k: p.grad.double().cpu() for k, p in net.named_parameters()})
    (m_card, g_card), (m_host, g_host) = stepped["cuda"], stepped["cpu"]
    lerr = abs(m_card["loss"] - m_host["loss"]) / abs(m_host["loss"])
    check(lerr <= 1e-4, f"card vs CPU, path 7: loss {m_card['loss']} vs {m_host['loss']}")
    rel = {k: float((g_card[k] - g).norm() / g.norm().clamp(min=1e-30)) for k, g in g_host.items()}
    a = torch.cat([g.flatten() for g in g_host.values()])
    b = torch.cat([g_card[k].flatten() for k in g_host])
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    worst = max(rel, key=rel.get)
    check(cos > 0.9999 and rel[worst] <= 2e-2,
          f"card vs CPU, path 7: gradient cosine {cos}, {worst} relative L2 {rel[worst]}")
    log(f"card vs CPU, path 7's step in f32 (R18, 64x64, 2 groups): loss {m_card['loss']} vs "
        f"{m_host['loss']} (relative {lerr:.2e}), gradient cosine {cos:.8f}, worst relative "
        f"L2 {rel[worst]:.2e} ({worst}); terms {m_card} vs {m_host} "
        f"({time.perf_counter() - t:.1f} s)")

    # path 8's step in f32 on a small model (R18, 64x64, 4 groups, the full
    # critics), one step of each parity: gan_card_vs_cpu
    cfg_s8 = gan_config(18, 64, 16)
    batch_s8 = gan_batch(4, 64, 16, 16, "cpu", seed=10)
    for parity in (0, 1):
        t = time.perf_counter()
        line, failures = gan_card_vs_cpu(cfg_s8, batch_s8, parity, dev, seed=11)
        log(f"card vs CPU, path 8's step in f32 (R18, 64x64, 4 groups, parity {parity}): "
            f"{line} ({time.perf_counter() - t:.1f} s)")
        check(not failures, f"card vs CPU, path 8 parity {parity}: {failures}")

    log(path9_card_vs_cpu(checks9))

    # path 11: one QAT step (qat_card_vs_cpu) and the int8 eval step on one
    # group of 11a (no bank) and of 11b (the bf16 bank), through the same
    # qparams on both
    line, failures = qat_card_vs_cpu(dev)
    log(f"card vs CPU, {PATH11}'s QAT step (R18, 64x64, 2 groups): {line}")
    check(not failures, f"card vs CPU, {PATH11} QAT: {failures}")
    for tag, cfg_, pairs_, quant_, batch_ in seen11.pop("card_vs_cpu"):
        t = time.perf_counter()
        line, failures = eval_step_card_vs_cpu(cfg_, pairs_, quant_, batch_, dev)
        log(f"card vs CPU, {PATH11} {tag}'s int8 eval step on one group: {line} "
            f"({time.perf_counter() - t:.1f} s)")
        check(not failures, f"card vs CPU, {PATH11} {tag}: {failures}")

    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
