#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU, and checks it.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which ends the run with a non-zero exit when it fails:

1. Identify the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions); stop when ``torch.cuda.is_available()`` is false.
2. Build the CUDA kernels from ``semantic_embeddings_torch/csrc/``, one
   ``nvcc`` per source, all at once; print each build's time and ptxas's
   register and spill lines.
3. Hold the cosine-loss kernels against their plain PyTorch versions on the
   card, in f32 and bf16, at the training path's shape (100, 100) and at
   (37, 100), (256, 512) and (4, 16) with two all-zero rows; time both at
   (100, 100), beside their bound, the library call of the same function
   (``cosine_embedding_loss``, forward and forward + backward) and the
   launch floor (an empty kernel's time).
4. Hold the 3x3 conv + BN-statistics kernel and the 3x3 filter-gradient
   kernel (both on the tensor cores: bf16 as bf16, f32 as 3xTF32) against
   their plain versions, and f32 y and dw against f64, in f32 and bf16
   (TF32 off), at the four ResNet-50 stage shapes at batch 128 (224 px) and
   at batch 24 (448 px, the CUB recipe's), four ragged shapes and three
   shapes that take each copy path (16-byte planes, or the repack), after
   each ``wgmma`` kernel's product on its own against ``torch.matmul`` (each
   conv instance's at each N it uses) and the f32 kernels' accumulation
   against f64 by the terms they sum in the tensor cores; print the instance each
   dtype runs, the copy width each shape
   takes and the distance of y from f64 (the kernel's and cuDNN's).  At the eight
   stage shapes time both kernels, their plain versions and cuDNN's
   wgrad, and print each kernel's bound (the larger of operations over the
   peak and bytes over 3.35 TB/s; the peak is bf16's 989 TFLOP/s, and for
   f32 that of f32-exact products on the tensor cores, 3xTF32 at 495 / 3
   TFLOP/s, with the f32 FMA units' 67 TFLOP/s beside it) and its share of
   it; give each kernel's device time by the kernels its wrapper launches,
   each wrapper's host time a call, and the SHA-256 of each output on
   inputs from a fixed seed (``conv_records``, which takes any tree's
   ``ops.conv3x3``, so two trees' outputs can be compared bit for bit).
4b. Hold the 1x1 convs' f32 weight-gradient kernel (3xTF32 on TF32
   ``wgmma``) against f64, and bitwise over two launches, at its ragged
   cases, a misaligned operand and ResNet-50's 15 1x1 shapes at batch 128;
   time it there beside ``conv2d_weight`` and its bound, summed over a
   step's 36 convs; the host time the op adds to a ResNet-50 step (a
   host-paced step, batch 2 at 64 px); count its launches: 36 in an f32 ResNet-50 step (also
   with ``remat``), 4 in rn18's, none in a bf16 step, an inference
   forward, an exported program's call or the other families' steps, and
   the op not taken under a spatial grid.
4c. Hold the three f32 depthwise kernels (forward, input gradient, weight
   gradient) against f64 and dw bitwise over two launches, at the op's
   ragged cases and NASNet-A Large's 23 depthwise shapes at batch 128; time
   each pass there (device and event time) beside its bound, the op's
   plain version and ATen's call, summed over a step's 220 layers; check
   that each wrapper launches its one kernel, and that a NASNet-A step
   launches each kernel 220 times and none of ATen's depthwise kernels,
   and none under bf16 autocast or a spatial grid.
5. Slice 1: compute a unitsphere class embedding for a generated 100-leaf
   taxonomy (20 superclasses x 5 leaves) with ``python -m
   semantic_embeddings_torch.cli.compute_class_embedding`` (E E^T must
   equal 1 - lcs_height to 1e-12), then train resnet-110-wfc with
   ``--fused_loss`` for one epoch of ``synthetic-100-2000-500`` at batch
   100 (20 steps), validate and dump test features and the model, through
   ``learn_image_embeddings.main``.  Checks finite losses, one launch of
   each cosine kernel per train step, every parameter on the card, and 500
   unit-norm feature rows.
5b. Stage 3 on those dumps: ``python -m
   semantic_embeddings_torch.cli.evaluate_retrieval --device cuda`` in its
   own process on the feature dump and on a centered copy of it (every
   metric finite and in [0, 1]; its table and CSV equal this process's card
   run), and the port's CPU run of ``evaluate_retrieval_features`` on both:
   on the centered copy, per-query values within 1e-5 for 99% of the
   queries, and the card's means and the CLI's CSV within 1e-3 of the
   CPU's (on the dump as it is, whose features have nearly collapsed after
   20 steps, the disagreement is printed); the features' spread before
   training and after; then ``evaluate_classification_accuracy`` with
   ``--centroids`` (the class embedding; its accuracy equals a host argsort
   of the feature dump's) and ``--prob_features --layer prob``.
5c. The exact top-k (tie-heavy rows and rows of +-inf) and the ranked class
   ids of both ranking paths on the card, bitwise equal to the CPU's.
5d. Retrieval queries per second, ``bench_retrieval.py``'s two protocols on
   synthetic features: CIFAR-100 test size (10,000 x 100, full sort with
   AP) and ILSVRC val size (50,000 x 1,000, 1,000 leaves, the top-k
   prefix); median, min and max of 5 runs and the device busy share.
6. One resnet-110-wfc train step through the kernels against one through
   the plain versions, from one copied state and one batch with fixed
   augmentation.
7. Time 10 steady-state resnet-110-wfc train steps (f32, batch 100).  With
   ``--profile DIR`` also profile the step in f32 and bf16 (device time,
   GPU kernels per step, busy share, peak memory; tables into DIR) and time
   the host's issue of each piece of an f32 step.
8. Slice 2: ResNet-50 at 224 px, full depth and published widths, batch
   128, inv_corr through the cosine kernels plus the 0.1 softmax head,
   clipnorm 10, on ``SyntheticDataset(100, n_train=512, n_test=128,
   size=224)``, through ``build_network``, ``EmbeddingModel``,
   ``make_train_step``, ``fit`` (one epoch: 4 steps, then validation) and
   ``extract_test_features``, in f32.  Checks finite losses, 16 launches of
   the conv kernel per forward and 16 of the filter-gradient kernel per
   backward, one launch of each cosine kernel per step, every parameter and
   buffer on the card, and 128 unit-norm feature rows.
9. One ResNet-50 train step through the kernels against one through the
   plain versions and one through the plain versions in f64, from one
   copied state, TF32 off: the losses agree to 1e-5 relative, and no
   tensor of the kernel step is farther from the f64 step than twice the
   plain f32 step's farthest.
10. ResNet-50 train-step throughput in f32 and bf16, through the kernels
   and through the plain versions (in turns: kernel, plain, kernel; 8 steps
   each), and their device time, busy share and peak memory
   (``torch.profiler``, 3 steps).
10b. Serve phase 8's trained ResNet-50 through ``serve_model.make_server``
   and drive it over HTTP from 16 threads of another process (f32 npy
   wire, uint8 wire with ``--device_preproc``, bf16), and once more under
   ``torch.profiler``: see :func:`serve_resnet50`.
11. Import every module of the port (the model zoo's too) and check that
   neither JAX nor any module of the JAX package
   (``semantic_embeddings_tpu``) was imported.
12. The model zoo at its published widths, TF32 off: (a) build every
   architecture name (and ``resnet-110-selu`` and a ``classification``
   WRN) on the card from a fixed generator and run an eval forward at batch
   2 at its input size (finite outputs; parameter counts printed); (b)
   train ``simple``, ``wrn-28-10`` (with ``--cls_base top``, its dump then
   through ``evaluate_classification_accuracy --layer prob``) and
   ``pyramidnet-272-200`` at batch 128 and ``densenet-bc-190-40`` at batch
   64 through ``learn_image_embeddings`` in their own processes (one epoch
   of 3 batches, inv_corr through the cosine kernels + the 0.1 softmax
   head, feature and model dumps): finite losses, unit-norm features, and
   each model dump rebuilt reproduces its features within 1e-5; in this
   process, one step of each through the cosine kernels and one through the
   plain loss from the same weights (losses within 1e-6 relative, the
   kernel pair launched 1 + 1 times), then 8 warm steps timed (img/s of
   the median step, peak memory); (c) NASNet-A at 224 px, batch 32, 3 steps through ``fit`` in
   f32, then one bf16 autocast step, the model's depthwise counter at 220 a
   forward and the depthwise kernels' launch counters at 220 each a forward
   and backward (none in the bf16 step); (d) one ResNet-50 step with
   ``--remat`` and one without from the same weights: running statistics
   bitwise equal, loss and parameters within 1e-6 of each update,
   ``conv3x3_bn_stats`` launched 32 against 16 times, the filter gradient
   16 in both, and less peak memory with remat.
13. The kernels as ``torch.library`` custom ops on the new paths: (a)
   export phase 8's ResNet-50 with ``python -m
   semantic_embeddings_torch.cli.export_model --validate`` (batch -1, the
   l2norm tap), f32 and ``--bf16``, two processes at once; here each
   artifact holds 16 ``conv3x3_bn_stats`` nodes, launches 16 a call at
   batch 1 and 64, and equals the direct forward (f32 within 1e-5, bf16
   within the JAX CLI's 2e-2 relative); the export time and a call's time
   are printed; (b) serve the f32 artifact with ``serve_model --artifact``
   as 10b serves the checkpoint (the same client process, checks and
   numbers); (c) ``learn_classifier`` with the CosineLoss.md recipe's flags
   (resnet-50 at 224 px, ``--label_smoothing 0.1``, SGDR, batch 24,
   ``--bf16``) for one epoch of 4 steps on a synthetic 224-px set with a
   model dump: 16 + 16 conv launches a step, the step timed and its peak
   memory; ``evaluate_classification_accuracy`` reads the dump; then
   ``learn_image_embeddings --finetune`` from it with ``--finetune_init
   1``: after phase 1 every backbone parameter is bitwise as loaded and
   both tops moved, the cosine pair launched 1 + 1 a step and the filter
   gradient not at all; phase 2 launches all four; (d) ``learn_devise``
   (``--init_weights`` from phase 5's dump, both phases),
   ``learn_labelembedding`` and ``learn_center_loss`` (learned and fixed
   centroids) on resnet-110-wfc at batch 100, four processes at once, one
   epoch of 5 steps: finite training losses (validation after 5 steps may
   overflow: the BN running statistics are still near their initial
   values), each dump rebuilt reproduces its features within 1e-5 of their
   size (NaN where they are NaN), the features are finite and within 1e-5
   of each row's largest magnitude of a float64 forward of the same weights
   wherever that forward stays inside float32's range (with fixed centroids
   it may pass it, and those features are then NaN), fixed centroids
   unchanged; each learner's step timed here with its peak memory; (e,
   first) the host time of a call
   through each custom op against its kernel's wrapper called directly
   (small shapes, 500 calls, in turns), and what that dispatch adds to a
   slice 1 and a ResNet-50 step.
14. The file datasets on the CosineLoss.md CUB recipe (ResNet-50 at 448
   px, batch 24, bf16): (a) probe the host's JPEG libraries (libjpeg's
   header and libraries, Pillow, nvJPEG's header, the cores) and build the
   native decoder: plan A where it builds (the datasets decode with it),
   plan B where it does not and Pillow is present (the datasets take
   Pillow's path, ``--decoder pillow``, and g++'s error is printed as a
   finding); (b) write a CUB layout from the seed: 200 classes of 3
   training and 1 test JPEG, shorter sides of 300-500 px, aspects of
   0.75-1.33, class-dependent content, one grayscale; (c) the host decode
   rates of CUB's test and train transforms on 1 and 8 threads (plan A:
   native center crops within a mean |diff| of 12 of Pillow's); (d) the
   recipe through ``learn_image_embeddings --dataset cub`` (``--fused_loss``,
   2 epochs, feature and model dumps) in its own process: finite losses,
   the conv kernels 16 + 16 a step and the cosine pair 1 + 1, the pipeline
   flags in the dataset; (e) beside it, one step on a batch from the file
   pipeline through the kernels and through the plain versions, in f32
   (TF32 off) and bf16, each held to an f64 step as phase 9 does; (f) the
   step's img/s at batch 24 with the batch resident on the card and fed by
   the file pipeline, the busy share under ``torch.profiler``, and the host
   cores the step needs (device img/s over decode img/s per core); (g)
   ``evaluate_retrieval`` (the default ``--plot_max``, past the 199 other
   test images: P@k clamps as the JAX package's does) and
   ``evaluate_classification_accuracy`` (the default ``--decoder auto``,
   whose choice it checks) on (d)'s
   dumps over a two-level taxonomy of the 200 classes, and the SVM mode's
   augmented feature pass (2 passes with the host's train transforms); (h)
   ``learn_classifier --dataset cub --label_smoothing 0.1`` and
   ``learn_image_embeddings --dataset nab-large`` (one epoch each on a
   50-class copy of (b)'s files made of symlinks), in their own processes
   beside (g)'s, and the classifier's dump through
   ``evaluate_classification_accuracy --layer prob``; (i) serve (d)'s model
   with ``--decode_threads``: a JPEG body's answer equals, bitwise, the
   answer to the npy body of the pixels the server's decoder gives.
15. Checkpoint interop and the host-side CLIs, at full width: (a) probe
   ``h5py``, ``matplotlib`` and ``tensorboard`` (nothing is installed); (b)
   write phase 8's ResNet-50 as a JAX package model dump
   (``save_jax_checkpoint``: the pickle around the Flax msgpack of the
   train state), time its read, rebuild it through
   ``rebuild_model_from_checkpoint``: every tensor and the eval forward
   bitwise equal to the source's (16 ``conv3x3_bn_stats`` launches), and
   ``evaluate_classification_accuracy`` on it and on the source in their
   own processes gives the same table; (c) ``learn_image_embeddings
   --finetune`` from a JAX weight dump of it (a 50-d embedding, so the
   100-d top is skipped; batch 32, ``--finetune_init 1``, 3 steps a phase,
   ``--log_dir``): the backbone loads whole, the BN running statistics keep
   their initial values, the launches of all four kernels by phase, and
   TensorBoard events where ``tensorboard`` imports; (d) export phase 8's
   ResNet-50 and phase 5's resnet-110-wfc to Keras h5 and import them back
   (through h5 files and both CLIs where ``h5py`` imports, else
   ``export_layers`` straight to ``map_layers``): every tensor and the eval
   forward bitwise equal to the source's; (e) ``compute_class_embedding
   --device`` on phase 5's taxonomy: E E^T within 1e-10 of the
   similarities and of the host run's, unitsphere and approx_sim; (f)
   ``plot_recall_precision`` on phase 5's feature dump (where
   ``matplotlib`` imports) and ``encode_hierarchy`` on a tree written from
   the seed.
16. Data parallelism on the one card, TF32 off, at full width: (a) phase
   8's recipe (ResNet-50 @ 224, batch 128, f32) for 3 steps through
   ``fit`` in an NCCL group of world size 1, in a process of its own under
   a launcher's environment, against the same 3 steps there without a
   group, before and after (deterministic cuDNN): every parameter and
   running statistic bitwise equal, 16 / 16 / 1 / 1 launches a step, the
   times of the three; (b) after a first step that is not kept, phase 9's step on
   two gloo ranks sharing the card (two processes; NCCL takes one rank a
   card), 64 rows each, sync BN: no tensor farther from phase 9's f64 step
   than twice phase 9's one-process f32 step's farthest, the running
   statistics within 1e-5 relative of the one-process step's and equal on
   both ranks, each rank's launches those of one step; (c) the same under
   per-replica BN, held to the one-process ``_GroupedBatchNorm(groups=2)``
   step and its f64 twin; (d) ``learn_image_embeddings --gpus 2`` in its
   own processes, without a launcher (the JAX package's message, one card)
   and under a launcher's environment of world size 1 (an NCCL group);
   (e) retrieval at ILSVRC val size (phase 5d's 50,000 x 1,000 features)
   with the database's rows over [cuda:0, cuda:0] (``--db_sharded``) and
   with the query blocks over them, against one device: the same metrics,
   every ranking bitwise equal, q/s of each; (f) the serving engine over
   two replicas of phase 8's ResNet-50 on [cuda:0, cuda:0] against one:
   outputs within 1e-6, img/s of each.  Two ranks on one card measure
   neither NCCL nor scaling.
17. Spatial partitioning (``--spatial``), ``--profile_dir`` and
   ``pairwise_matrices_device``: (a) both conv kernels, f32 and bf16, on
   each row block of the CUB recipe's stage shapes (ResNet-50 @ 448, batch
   24) over S = 2 columns, and of stage 4 over S = 4 (blocks of 4, 4, 4, 2
   rows), with the halo rows: against their plain halo versions, y bitwise
   the whole-image launch's rows, the blocks' sums within 1e-6 of the sum of
   |terms| and dw within 1e-5 of max |dw| of the whole image's; ms per call
   on the largest block beside the whole-image launch scaled to its rows and
   the block's bound; (b) the recipe (``--fused_loss``) on two gloo ranks
   sharing the card as a (1, 2) grid, one f32 step (TF32 off) and then 3
   bf16 steps, against the same steps in one process from the same weights
   and batch: the f32 step's loss within 1e-5 relative, its worst parameter
   no farther from an f64 step than 1.5 times the one-process step's, its
   running statistics within 1e-5 relative; the bf16 step's loss within
   2^-8 of the f64 loss, its median parameter within 1.5 times the
   one-process step's median distance from f64 and its worst within 3 times
   (bf16's rounding swings a worst tensor); in both the worst running
   statistic within twice the one-process step's; 16 + 16 halo launches of
   the conv kernels a step on each rank; seconds a step (the halos go
   through the host on gloo: no speed claim); (c) ``learn_image_embeddings --profile_dir`` on slice 1's
   recipe for 40 steps: the trace of steps 10-29 written with the JAX
   package's message, naming the cosine kernels; (d)
   ``pairwise_matrices_device`` on the card for a 1,000-leaf tree from the
   seed: bitwise its CPU run, within 1e-7 of the host path's f64 matrices.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 100
DATASET = "synthetic-100-2000-500"
N_TRAIN, N_TEST = 2000, 500
# slice 2: ResNet-50 at 224 px
RN50_BATCH = 128
RN50_TRAIN, RN50_TEST = 512, 128
RN50_CONVS = 16  # bottleneck blocks, each with one 3x3 conv_b feeding bn_b
RN50_1X1 = 36  # 1x1 convs: 16 conv_a, 16 conv_c, 4 projection shortcuts
STAGE_BLOCKS = (3, 4, 6, 3)  # of them in each of ResNet-50's four stages
# Published peaks of one H100 SXM (dense): bf16 tensor cores, f32 FMA
# outside the tensor cores (TF32 stays off), f32-exact products on the
# tensor cores as 3xTF32 (three TF32 products at 495 TFLOP/s each), and
# device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
PEAK_BYTES = 3.35e12


def bound(flop, nbytes, dtype_name):
    """The least time in ms the card could take: the larger of the
    operations over the dtype's peak and the bytes over the memory rate;
    and which of the two it is."""
    ops_ms = flop / PEAK_FLOPS[dtype_name] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


_START = time.perf_counter()


def phase(name):
    """Prints the phase's name and the seconds since the script started."""
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def check(condition, detail="check failed"):
    """Fails the run (an exception, so a non-zero exit) unless ``condition``."""
    if not condition:
        raise RuntimeError(f"chip_smoke: {detail}")


def time_ms(fn, iters=200, warmup=20):
    """Median device time of one call of ``fn``, from CUDA events around
    each call (after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_ms(fn, iters=50, attempts=4):
    """Device time of one call of ``fn``: the summed duration of the GPU
    kernels it launches, from ``torch.profiler``, without the gaps in which
    the device waits for the host.  Returns the time and the reading's
    record: ``records_lost`` in each of its two windows and ``rescaled``.

    The profiler now and then loses some or all of a window's kernel
    records, and a sum then reads low.  Every call of ``fn`` launches the
    same kernels, so each kernel's time a call is its mean record times its
    launches a call (its records over ``iters``, rounded).  A reading takes
    two windows of ``iters`` calls and is kept when, in both, every kernel
    has lost at most a tenth of its records and launches as often a call;
    otherwise both are taken again, and after ``attempts`` the run fails.
    Where no record was lost the time is the windows' plain sum over
    ``iters``; else ``rescaled`` is true.  A kernel whose records all
    vanish in both windows is not seen.  ``by_kernel_ms`` gives each
    kernel's share of the time, by its name up to the argument list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count > 0]
        launches = {e.key: round(e.count / iters) for e in kernels}
        whole = bool(kernels) and all(
            launches[e.key] >= 1 and launches[e.key] * iters - iters // 10 <= e.count
            <= launches[e.key] * iters for e in kernels)
        lost = sum(launches[e.key] * iters - e.count for e in kernels)
        by_kernel = {e.key: e.self_device_time_total / e.count * launches[e.key] / 1e3
                     for e in kernels}
        return whole, launches, lost, by_kernel

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        (ok1, l1, lost1, k1), (ok2, l2, lost2, k2) = window(), window()
        t1, t2 = sum(k1.values()), sum(k2.values())
        if ok1 and ok2 and l1 == l2:
            by_kernel = {}
            for key in k1:
                name = re.sub(r"^void |\(anonymous namespace\)::", "", key).split("(")[0]
                by_kernel[name] = by_kernel.get(name, 0.0) + (k1[key] + k2[key]) / 2
            record = {"records_lost": [lost1, lost2], "rescaled": lost1 + lost2 > 0,
                      "by_kernel_ms": by_kernel}
            if record["rescaled"]:
                print(f"torch.profiler lost {lost1} and {lost2} GPU kernel records of "
                      f"twice {iters} calls; each kernel's mean record is scaled by its "
                      f"{l1} launches a call")
            return (t1 + t2) / 2, record
        print(f"torch.profiler lost {lost1} and {lost2} GPU kernel records of twice "
              f"{iters} calls, or the kernels differ (attempt {attempt + 1}); taken again")
    raise RuntimeError("torch.profiler lost kernel records in every attempt")


def host_us(fn, iters=20, warmup=3):
    """Median host time of one call of ``fn`` in microseconds: what the host
    takes to run it and queue its kernels, without waiting for the device
    (which finishes the calls after the last reading)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def conv_records(CC, device, seed=4):
    """For each stage shape of phase 4 and each dtype, on inputs from
    ``seed``: the SHA-256 of the bytes of y, Σy and Σy² (one conv +
    statistics launch) and of dw (one filter-gradient launch), and each
    wrapper's host microseconds a call (``host_us``).  ``CC`` is a tree's
    ``semantic_embeddings_torch.ops.conv3x3``, so that the kernels of two
    trees can be held together bit for bit on the same inputs (this tree's
    :mod:`~semantic_embeddings_torch.ops.checks` draws them)."""
    import hashlib

    import torch

    from semantic_embeddings_torch.ops import checks

    def sha(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    gen = torch.Generator(device=device).manual_seed(seed)
    records = {}
    for case in checks.STAGE_SHAPES + checks.STAGE_SHAPES_448:
        for dtype in (torch.float32, torch.bfloat16):
            x, wt, dy = checks.conv3x3_check_inputs(case, dtype, gen)
            y, s, ss = CC._launch_conv_bn_stats(x, wt)
            dw = CC._launch_filter_grad(x, dy)
            records[case, dtype] = {
                "conv3x3_bn_stats": {
                    "sha256": {"y": sha(y), "s": sha(s), "ss": sha(ss)},
                    "host_us": host_us(lambda: CC._launch_conv_bn_stats(x, wt))},
                "conv3x3_filter_grad": {
                    "sha256": {"dw": sha(dw)},
                    "host_us": host_us(lambda: CC._launch_filter_grad(x, dy))}}
            del x, wt, dy, y, s, ss, dw
    torch.cuda.empty_cache()
    return records


def profile_step(state, step, batches, label, path=None, n=10, batch=BATCH):
    """Wall time per train step without the profiler, then ``torch.profiler``
    over ``n`` steps: the device time of the step's GPU kernels, their count,
    the device's busy share (device time / wall time) and the peak device
    memory.  The profiler's tables go to ``path`` when it is given.  Returns
    the numbers as a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator(device="cuda").manual_seed(0)
    for raw in batches[:5]:
        step(state, raw, 0.1, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for raw in batches:
        step(state, raw, 0.1, rng)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(batches) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for raw in batches[:n]:
            step(state, raw, 0.1, rng)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    check(kernels, "torch.profiler recorded no GPU kernel")
    device = sum(e.self_device_time_total for e in kernels) / n / 1e3
    launches = sum(e.count for e in kernels) / n
    result = {"wall_ms": wall, "img_per_s": batch / wall * 1e3, "device_ms": device,
              "busy": device / wall, "kernels_per_step": launches, "peak_gib": peak}
    print(f"profile {label}: wall {wall:.2f} ms/step "
          f"({batch / wall * 1e3:.1f} img/s), device {device:.2f} ms/step, "
          f"busy share {device / wall:.3f}, {launches:.0f} GPU kernels/step, "
          f"peak memory {peak:.3f} GiB")
    if path is None:
        return result
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"train step, {label}: {n} steps under torch.profiler\n\n"
                "GPU kernels by device time:\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=30,
                             max_name_column_width=90))
        f.write("\n\nhost ops by the device time of what they launch:\n")
        f.write(events.table(sort_by="device_time_total", row_limit=40,
                             max_name_column_width=90))
        f.write("\n\nhost ops by calls:\n")
        f.write(events.table(sort_by="count", row_limit=30,
                             max_name_column_width=90))
    return result


def host_pieces(state, step, prepare, spec, raw, label, n=10):
    """For each piece of one train step: the host time to issue it (no sync
    inside the loop) and the time to the end of its device work."""
    import torch

    from semantic_embeddings_torch.train.optimizer import sgd_update

    model = state.model.twin("linear", cls_input="l2norm")
    rng = torch.Generator(device="cuda").manual_seed(0)
    images, _ = prepare(raw, rng, True)
    params = state.params
    grads = [torch.zeros_like(p) for p in params]

    def forward():
        model.train()
        return model(images)

    def forward_backward():
        z, prob = forward()
        torch.autograd.grad(z.sum() + prob.sum(), params)

    pieces = {
        "prepare": lambda: prepare(raw, rng, True),
        "forward": forward,
        "forward+backward": forward_backward,
        "l2 penalty": lambda: spec.l2_penalty(model),
        "clip+sgd update": lambda: sgd_update(
            params, state.velocity, grads, 0.0, clipnorm=10.0),
        "whole step": lambda: step(state, raw, 0.0, rng),
    }
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"host {label} {name}: issue {(t1 - t0) / n * 1e3:.2f} ms, "
              f"to the end of its device work {(t2 - t0) / n * 1e3:.2f} ms")


def write_taxonomy(path):
    """A 100-leaf tree shaped like CIFAR-100's coarse/fine split: root 200,
    superclasses 100..119, leaves 0..99 (5 per superclass)."""
    with open(path, "w") as f:
        for s in range(20):
            f.write(f"200 {100 + s}\n")
            for leaf in range(5):
                f.write(f"{100 + s} {5 * s + leaf}\n")


def write_taxonomy_1000(path):
    """A 1,000-leaf tree, 10 x 10 x 10: root 3000, nodes 2000 + i and
    1000 + 10 i + j, leaves 0..999."""
    with open(path, "w") as f:
        for i in range(10):
            f.write(f"3000 {2000 + i}\n")
            for j in range(10):
                f.write(f"{2000 + i} {1000 + 10 * i + j}\n")
                for k in range(10):
                    f.write(f"{1000 + 10 * i + j} {100 * i + 10 * j + k}\n")


def run_cli(module, *argv):
    """Runs a CLI of the port in its own process; returns its stdout."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"semantic_embeddings_torch.cli.{module}", *argv],
        cwd=ROOT, capture_output=True, text=True)
    print(f"{module} ran in {time.perf_counter() - t0:.1f} s (exit {proc.returncode})")
    print(proc.stdout.strip())
    if proc.returncode:
        print(proc.stderr[-4000:])
    check(proc.returncode == 0, f"{module} failed")
    return proc.stdout


def parse_table(text):
    """``{row: {metric: value}}`` from a CLI's printed performance table
    (a "--" cell is left out)."""
    lines = text.splitlines()
    # the table's header stands on the line above its rule of dashes (other
    # lines may hold " | ", as a compiler's message does)
    rule = max(i for i, line in enumerate(lines) if line and set(line) == {"-"})
    header = [cell.strip() for cell in lines[rule - 1].split(" | ")][1:]
    rows = {}
    for line in lines[rule + 1:]:
        if " | " not in line:
            break
        cells = [cell.strip() for cell in line.split(" | ")]
        rows[cells[0]] = {m: float(v) for m, v in zip(header, cells[1:]) if v != "--"}
    return rows


def protocol_features(n, d, n_classes):
    """``bench_retrieval.py``'s synthetic features: unit rows, class i's
    shifted by 2 along axis i; and their labels."""
    rng = np.random.default_rng(0)
    labels = [i % n_classes for i in range(n)]
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats[np.arange(n), labels] += 2.0
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats, labels


def retrieval_protocol(n, d, n_classes, hierarchy, full_ap, device, card, runs=5,
                       block_size=2048, budget_s=60.0):
    """One protocol of ``bench_retrieval.py:20-71`` through the port's
    ``evaluate_retrieval_features`` on the card: synthetic unit features
    (class i's rows shifted by 2 along axis i), P@k and AHP@250, and AP when
    ``full_ap`` (the full sort; else the top-k prefix).  Queries per second
    of ``runs`` timed runs after one warm-up, and the device busy share of
    one profiled run.  Rows are cut where the whole would take more than
    ``budget_s``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semantic_embeddings_torch.evaluation.retrieval import evaluate_retrieval_features

    def data(n):
        return protocol_features(n, d, n_classes)

    kwargs = dict(ks=[1, 10, 50, 100], compute_ahp=250, compute_ap=full_ap,
                  normalize=True, block_size=block_size, device=device)
    feats, labels = data(n)
    t0 = time.perf_counter()
    evaluate_retrieval_features(feats, labels, hierarchy, **kwargs)  # warm-up
    warm_s = time.perf_counter() - t0
    cut = None
    if warm_s * (runs + 2) > budget_s:
        cut_n = max(n_classes, int(n * budget_s / (warm_s * (runs + 2))) // n_classes * n_classes)
        cut = f"rows cut from {n} to {cut_n}: the warm-up took {warm_s:.1f} s"
        print(cut)
        n = cut_n
        feats, labels = data(n)
        evaluate_retrieval_features(feats, labels, hierarchy, **kwargs)
    torch.cuda.reset_peak_memory_stats()
    rates, walls = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        means, _ = evaluate_retrieval_features(feats, labels, hierarchy, **kwargs)
        walls.append(time.perf_counter() - t0)
        rates.append(n / walls[-1])
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluate_retrieval_features(feats, labels, hierarchy, **kwargs)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(kernels, "torch.profiler recorded no GPU kernel")
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    wall = statistics.median(walls)
    # device bytes: the database, one similarity block, the (C, k) optimal
    # curves (k = N - 1 for the full sort) and the (C, C) similarity tables
    k = n - 1 if full_ap else 250
    nbytes = 4 * (n * d + block_size * n + 2 * n_classes * k + 2 * n_classes ** 2)
    total = torch.cuda.get_device_properties(device).total_memory
    check(nbytes < total and peak < total, (nbytes, peak, total))
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in means.values()), means)
    result = {"n": n, "d": d, "classes": n_classes, "full_ap": full_ap,
              "block_size": block_size, "qps_median": statistics.median(rates),
              "qps_min": min(rates), "qps_max": max(rates), "runs": runs,
              "busy": device_s / wall, "device_s": device_s, "wall_s": wall,
              "device_bytes_counted": nbytes, "peak_bytes": peak,
              "mAHP@250 (LCS_HEIGHT)": means["AHP@250 (LCS_HEIGHT)"], "cut": cut,
              "card": card}
    print(f"retrieval {n} x {d}, {n_classes} classes, "
          + ("P@k + AHP@250 + AP (full sort)" if full_ap else "P@k + AHP@250 (top-k)")
          + f": median {result['qps_median']:.1f} q/s (min {min(rates):.1f}, max "
          f"{max(rates):.1f}, {runs} runs), busy share {result['busy']:.3f} "
          f"({device_s:.3f} s device of {wall:.3f} s); device bytes counted "
          f"{nbytes / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB of "
          f"{total / 2**30:.1f}; mAHP@250 {result['mAHP@250 (LCS_HEIGHT)']:.4f}  [{card}]")
    return result


SERVE_IMAGES, SERVE_THREADS, SERVE_SIZE = 256, 16, 224
# every request of a timed serving pass, as its client sees it (first sent
# to answered, a retry included), within this many seconds; a whole pass
# takes about 1 s
SERVE_REQUEST_BOUND_S = 15.0
# the clients' socket timeout.  A request whose connection stalls in the
# connect or the send (``URLError``) is sent once more on a new connection,
# and counted: once in a pass at most.  A late answer is not retried.
SERVE_ATTEMPT_S = 10.0
#: bf16 against f32 serving: the unit-norm 100-d outputs within 0.05 of each
#: other elementwise and at cosine >= 0.99 (bf16 keeps 8 significant bits;
#: ResNet-50's 53 layers add up a few 2**-8 relative errors)
BF16_ATOL, BF16_MIN_COS = 0.05, 0.99


def serve_traffic():
    """The served images (uint8, 224 px, from a seed) and the requests as
    (first image, size) pairs of 1-8 images."""
    rng = np.random.default_rng(7)
    pixels = rng.integers(0, 256, (SERVE_IMAGES, SERVE_SIZE, SERVE_SIZE, 3)).astype(np.uint8)
    sizes = []
    while sum(sizes) < SERVE_IMAGES:
        sizes.append(int(min(rng.integers(1, 9), SERVE_IMAGES - sum(sizes))))
    return pixels, list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes))


def drive_clients(url, wire, commands, results):
    """Runs in a process of its own, so that the clients' host work does not
    share the server's interpreter: on each "run" from ``commands`` sends
    every request of :func:`serve_traffic` from 16 threads through the
    port's client over the ``wire`` dtype, and puts (predictions, errors,
    seconds from the first request to the last answer, each request's
    seconds, the retried requests' first errors) on ``results``."""
    import threading
    import urllib.error

    from semantic_embeddings_torch.serving import ServingClient

    pixels, requests = serve_traffic()
    wire_dtype = np.dtype(wire)
    images = pixels if wire_dtype == np.uint8 else pixels.astype(wire_dtype)
    client = ServingClient(url, timeout=SERVE_ATTEMPT_S)
    results.put("ready")
    while commands.get() == "run":
        preds = np.full((SERVE_IMAGES, 100), np.nan, np.float32)
        errors, seconds, retried = [], [], []

        def worker(mine):
            try:
                for start, size in mine:
                    t = time.perf_counter()
                    try:
                        out = client.predict(images[start:start + size], wire_dtype=wire_dtype)
                    except urllib.error.URLError as e:
                        retried.append(f"{repr(e)} after {time.perf_counter() - t:.3f} s")
                        out = client.predict(images[start:start + size], wire_dtype=wire_dtype)
                    preds[start:start + size] = out
                    seconds.append(time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 - reported to the parent
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(requests[i::SERVE_THREADS],))
                   for i in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            errors.append("a client thread did not finish in 300 s")
        results.put((preds, errors, wall, seconds, retried))


def serve_resnet50(ckpt, device, card, CC, reset_counts, read_counts, artifact=None):
    """Serves the checkpoint through ``serve_model.make_server`` (max batch
    64, warm-up, ILSVRC statistics, the l2norm tap) and drives it with the
    port's client from 16 threads of another process: 256 images of 224 px
    in requests of 1-8, over the f32 npy wire, over the uint8 wire with
    ``--device_preproc``, and in bf16.  Each served batch is held against a
    direct eval forward of the same batch on the card (1e-5), each response
    against the served outputs (bitwise), every request of the timed pass
    to ``SERVE_REQUEST_BOUND_S`` as its client sees it (a stalled
    connection's retry, at most one a pass, is printed and kept), the conv
    + statistics kernel's launches to 16 a device call (and its plain
    version's to none); the same traffic once more under
    ``torch.profiler`` gives the device seconds and busy share; beyond
    ``--max_queue`` a request gets 503 with Retry-After, and in
    ``--device_preproc`` mode a float outside [0, 255] gets 400.  Before
    the timed run the traffic runs once untimed, and the engine's
    statistics are reset.  With ``artifact`` (phase 13b) it serves that
    ``export_model`` artifact (``--artifact``, f32 npy wire) instead, held
    to the same checks against the checkpoint's direct forward."""
    import multiprocessing
    import threading
    import urllib.error
    import urllib.request

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semantic_embeddings_torch.cli import common, serve_model
    from semantic_embeddings_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from semantic_embeddings_torch.serving import EngineOverloaded

    image = (SERVE_SIZE, SERVE_SIZE, 3)
    _, requests = serve_traffic()
    direct, _ = common.rebuild_model_from_checkpoint(ckpt, device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    spawn = multiprocessing.get_context("spawn")

    plain_calls = [0]
    plain = CC._plain_conv_bn_stats

    def counting_plain(x, w):
        plain_calls[0] += 1
        return plain(x, w)

    def npy(arr):
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        return buf.getvalue()

    def post_status(url, arr):
        req = urllib.request.Request(url + "/v1/predict", data=npy(arr), method="POST",
                                     headers={"Content-Type": "application/x-npy"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.headers
        except urllib.error.HTTPError as e:
            return e.code, e.headers

    def run(label, extra, wire_dtype):
        source = (["--artifact", artifact] if artifact
                  else ["--checkpoint", ckpt, "--layer", "l2norm"])
        args = serve_model.build_parser().parse_args([
            *source, "--input_size", str(SERVE_SIZE), "--port", "0",
            "--max_batch", "64", "--max_queue", "256", "--warmup", "--dataset", "ilsvrc",
            "--device", str(device), *extra])
        t0 = time.perf_counter()
        srv = serve_model.make_server(args)
        warm = srv.engine.warmup()  # as serve_model.main does for --warmup
        setup_s = time.perf_counter() - t0
        served, (fn,), retries = [], srv.engine._fns, []

        def recording(batch):  # each pack's batch is a fresh array
            out = fn(batch)
            served.append((batch, out))
            return out

        srv.engine._fns = [recording]
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        commands, results = spawn.Queue(), spawn.Queue()
        clients = spawn.Process(target=drive_clients, daemon=True,
                                args=(url, np.dtype(wire_dtype).name, commands, results))
        sys.stdout.flush()
        clients.start()

        def traffic():
            commands.put("run")
            preds, errors, wall, seconds, retried = results.get(timeout=600)
            check(not errors, errors[:3])
            if retried:
                print(f"serving {label}: a request's connection stalled and was sent "
                      f"again: {retried}")
                retries.extend(retried)
            check(len(retried) <= 1, f"{len(retried)} requests retried in one pass")
            return preds, wall, np.sort(seconds)

        try:
            check(results.get(timeout=120) == "ready", "the client process did not start")
            traffic()  # once untimed: the first requests of a process pay its set-up
            with srv.engine._lock:
                srv.engine._stats = dict.fromkeys(srv.engine._stats, 0)
                srv.engine._latencies.clear()
            del served[:]
            reset_counts()
            plain_calls[0] = 0
            preds, wall, seconds = traffic()
            counts, stats = read_counts(), srv.engine.stats()
            client_ms = {"p50": 1e3 * seconds[len(seconds) // 2],
                         "p99": 1e3 * seconds[int(len(seconds) * 0.99)],
                         "max": 1e3 * seconds[-1]}
            check(len(seconds) == len(requests)
                  and seconds[-1] <= SERVE_REQUEST_BOUND_S,
                  f"{len(seconds)} of {len(requests)} requests answered, the slowest in "
                  f"{seconds[-1]:.3f} s (bound {SERVE_REQUEST_BOUND_S} s)")
            calls = len(served)
            check(stats["batches"] == calls and stats["images"] == SERVE_IMAGES, stats)
            check(counts["conv3x3_bn_stats"] == RN50_CONVS * calls and plain_calls[0] == 0
                  and counts["conv1x1_filter_grad"] == 0, (counts, calls, plain_calls[0]))
            # every served batch against a direct eval forward of the same
            # batch (same composition, so cuDNN's same algorithms)
            worst = 0.0
            bf16 = torch.bfloat16 if "--bf16" in extra else None
            with torch.inference_mode(), common.maybe_autocast(device, bf16):
                for batch, out in served:
                    x = torch.from_numpy(batch).to(device)
                    if batch.dtype == np.uint8:
                        x = (x.float() - mean) / std
                    taps = {}
                    direct(x, taps=taps)
                    worst = max(worst, (taps["l2norm"].float() - out).abs().max().item())
            rows = {r.tobytes() for _, out in served for r in out.cpu().numpy()}
            norms = np.linalg.norm(preds.astype(np.float64), axis=1)
            check(worst <= 1e-5, f"served vs direct forward {worst:.3g}")
            check(all(p.tobytes() in rows for p in preds), "a response is no served row")
            check(np.isfinite(preds).all() and np.abs(norms - 1.0).max() <= 1e-5, norms)
            # the same traffic once more, under the profiler: the device's
            # share of the clients' wall time
            del served[:]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, prof_wall, _ = traffic()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            check(kernels, "torch.profiler recorded no GPU kernel while serving")
            device_s = sum(e.self_device_time_total for e in kernels) / 1e6
            n_lat = min(stats["requests"], 1024)
            result = {
                "wire": np.dtype(wire_dtype).name, "images": SERVE_IMAGES,
                "requests": len(requests), "threads": SERVE_THREADS,
                "clients": "16 threads in another process", "wall_s": wall,
                "img_per_s": SERVE_IMAGES / wall, "device_calls": calls,
                "conv3x3_bn_stats_launches": counts["conv3x3_bn_stats"],
                "served_vs_direct_max_abs": worst,
                "max_norm_err": float(np.abs(norms - 1.0).max()),
                "profiled": {"wall_s": prof_wall, "device_s": device_s,
                             "busy": device_s / prof_wall, "device_calls": len(served)},
                # engine.stats(): p99 is rank int(0.99 n) of n sorted latencies
                "p99_rank": f"{int(n_lat * 0.99) + 1} of {n_lat}",
                "client_ms": client_ms, "retried": retries,
                "setup_s": setup_s, "warmup_s": warm, "stats": stats, "card": card}
            print(f"serving {label}: {SERVE_IMAGES} images in {len(requests)} requests "
                  f"from {SERVE_THREADS} client threads in another process in {wall:.3f} s "
                  f"({result['img_per_s']:.1f} img/s); p50 {stats.get('latency_ms_p50')} ms, "
                  f"p99 {stats.get('latency_ms_p99')} ms (latency {result['p99_rank']}), "
                  f"client p50/p99/max {client_ms['p50']:.1f}/{client_ms['p99']:.1f}/"
                  f"{client_ms['max']:.1f} ms (bound {1e3 * SERVE_REQUEST_BOUND_S:.0f}), "
                  f"{len(retries)} retried, "
                  f"{calls} device calls, avg batch {stats['avg_batch']}; conv3x3_bn_stats "
                  f"launches {counts['conv3x3_bn_stats']} (16 x {calls}), plain 0; served vs "
                  f"direct {worst:.3g}; profiled run: {device_s:.4f} s device of "
                  f"{prof_wall:.3f} s, busy share {device_s / prof_wall:.3f}, {len(served)} "
                  f"device calls; setup + warm-up {setup_s:.1f} s  [{card}]")
            if label == "f32 npy":
                result["overload"] = overload(srv, url, recording)
            if "--device_preproc" in extra:
                code, _ = post_status(url, np.full((1, *image), 255.5, np.float32))
                check(code == 400, f"a float outside [0, 255] got {code}")
                print("device_preproc: a float 255.5 got 400")
        finally:
            commands.put("stop")
            clients.join(timeout=30)
            if clients.is_alive():
                clients.terminate()
                clients.join(timeout=10)
            srv.stop()
        return preds, result

    def overload(srv, url, recording):
        """Holds the device call and fills the queue: one request more gets
        503 with Retry-After."""
        gate = threading.Event()

        def gated(batch):
            gate.wait(120)
            return recording(batch)

        srv.engine._fns = [gated]
        zeros = np.zeros((64, *image), srv.engine.dtype)
        held = [srv.engine.submit(zeros)]
        deadline = time.time() + 30
        while srv.engine.stats()["pending_images"] and time.time() < deadline:
            time.sleep(0.01)  # the dispatcher takes the first into its call
        try:
            while True:
                held.append(srv.engine.submit(zeros))
        except EngineOverloaded:
            pass
        code, headers = post_status(url, np.zeros((1, *image), np.float32))
        pending = srv.engine.stats()["pending_images"]
        gate.set()
        for fut in held:
            fut.result(timeout=120)
        check(code == 503 and headers.get("Retry-After") == "1", (code, dict(headers)))
        print(f"overload: {pending} images pending (max_queue 256): HTTP {code}, "
              f"Retry-After {headers.get('Retry-After')}")
        return {"pending": pending, "code": code, "retry_after": headers.get("Retry-After")}

    CC._plain_conv_bn_stats = counting_plain
    if artifact:
        try:
            _, result = run("artifact f32 npy", [], np.float32)
        finally:
            CC._plain_conv_bn_stats = plain
        return {"artifact_f32_npy": result}
    try:
        f32, result_f32 = run("f32 npy", [], np.float32)
        _, result_u8 = run("f32 uint8 --device_preproc", ["--device_preproc"], np.uint8)
        b16, result_bf16 = run("bf16 npy", ["--bf16"], np.float32)
    finally:
        CC._plain_conv_bn_stats = plain
    cos = np.sum(f32.astype(np.float64) * b16, axis=1)
    err = float(np.abs(f32 - b16).max())
    print(f"bf16 vs f32 served outputs: max |diff| {err:.4g}, min cosine {cos.min():.6f} "
          f"(bounds {BF16_ATOL}, {BF16_MIN_COS})")
    check(err <= BF16_ATOL and cos.min() >= BF16_MIN_COS, (err, cos.min()))
    result_bf16.update(vs_f32_max_abs=err, vs_f32_min_cos=float(cos.min()))
    return {"f32_npy": result_f32, "f32_uint8_device_preproc": result_u8,
            "bf16_npy": result_bf16}


def feature_spread(feats, emb):
    """(mean per-dimension std of the rows, mean cosine of the rows to the
    normalised mean class embedding)."""
    mean_emb = emb.mean(axis=0)
    mean_emb = mean_emb / np.linalg.norm(mean_emb)
    unit = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    return float(feats.std(axis=0).mean()), float((unit @ mean_emb).mean())


def stage3(device, tmp, hierarchy, feat_path, model_path, emb_path, emb, feats):
    """Phase 5b: stage 3 of the main path on slice 1's feature and model
    dumps, through the port's two evaluation CLIs in their own processes,
    held against the port's CPU run."""
    import torch

    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.data import get_data_generator
    from semantic_embeddings_torch.embeddings.io import save_features
    from semantic_embeddings_torch.evaluation.retrieval import evaluate_retrieval_features
    from semantic_embeddings_torch.hierarchy import ClassHierarchy

    # After 20 steps the dump's features barely differ: the distances are
    # ~1e-6 of |f|^2, about the f32 rounding of the |q|^2 + |d|^2 - 2 q.d
    # sums, so on the dump as it is a rank follows the GEMM's order of sums.
    # Centered, the same features rank alike in exact arithmetic (Euclidean
    # ranking is translation invariant) and the sums are well conditioned:
    # there the card's and the CPU's GEMMs may flip only true near-ties.
    centered_path = os.path.join(tmp, "feat_centered.pickle")
    save_features(centered_path, feats - feats.mean(axis=0))
    csv_path = os.path.join(tmp, "retrieval.csv")
    out = run_cli("evaluate_retrieval", "--dataset", DATASET, "--data_root", tmp,
                  "--hierarchy", hierarchy, "--feat", feat_path, "--label", "slice1",
                  "--feat", centered_path, "--label", "centered",
                  "--csv", csv_path, "--device", "cuda")
    tables = parse_table(out)
    check(sorted(tables) == ["centered", "slice1"] and all(
        len(t) == 11 and all(0.0 <= v <= 1.0 for v in t.values())
        for t in tables.values()), tables)
    with open(csv_path) as f:
        rows = [line.strip().split(";") for line in f]
    check(rows[0] == ["k", "slice1", "centered"] and len(rows) == 251, rows[:2])
    csv = {name: {f"P@{r[0]} (LCS_HEIGHT)": float(r[1 + j]) for r in rows[1:]}
           for j, name in enumerate(rows[0][1:])}
    # the CLI's protocol (--plot_max 250: P@1..250, AHP, AP) in this process,
    # on the card and on the CPU
    labels_test = [int(c) for c in get_data_generator(DATASET).labels_test]
    taxonomy = ClassHierarchy.from_file(hierarchy, id_type=int)
    protocol = dict(ks=list(range(1, 251)), compute_ahp=True, compute_ap=True,
                    block_size=1024)

    def held(name, path):
        """The CLI's table (4 decimals) and CSV against this process's card
        run and the port's CPU run of the same dump: (queries whose values
        differ by more than 1e-5 between card and CPU, the largest
        per-query difference, the card's and the CLI's CSV's largest
        distance from the CPU's means, the CLI's from this process's card
        run)."""
        means, per_query = evaluate_retrieval_features(
            path, labels_test, taxonomy, device=device, **protocol)
        means_cpu, per_query_cpu = evaluate_retrieval_features(
            path, labels_test, taxonomy, device=torch.device("cpu"), **protocol)
        diff = np.stack([np.abs(np.array(list(per_query[m].values()))
                                - np.array(list(per_query_cpu[m].values())))
                         for m in sorted(per_query_cpu)])
        cli_vs_card = max(max(abs(v - means[m]) for m, v in tables[name].items()),
                          max(abs(v - means[m]) for m, v in csv[name].items()))
        card_vs_cpu = max(abs(means[m] - means_cpu[m]) for m in means_cpu)
        csv_vs_cpu = max(abs(v - means_cpu[m]) for m, v in csv[name].items())
        result = (int((diff.max(axis=0) > 1e-5).sum()), float(diff.max()),
                  card_vs_cpu, csv_vs_cpu, cli_vs_card)
        print(f"{name}: card vs the port's CPU run, {result[0]} of {N_TEST} queries differ "
              f"by more than 1e-5 (largest {result[1]:.3g}), means within {card_vs_cpu:.3g}; "
              f"the CLI's CSV within {csv_vs_cpu:.3g} of the CPU's means; the CLI's table "
              f"and CSV within {cli_vs_card:.3g} of this process's card run")
        check(cli_vs_card <= 1e-4, f"{name}: the CLI vs this process's card run")
        return result

    held("slice1", feat_path)  # printed: the collapsed dump ranks by rounding
    differing, _, card_vs_cpu, csv_vs_cpu, _ = held("centered", centered_path)
    check(differing <= 0.01 * N_TEST and card_vs_cpu <= 1e-3 and csv_vs_cpu <= 1e-3,
          (differing, card_vs_cpu, csv_vs_cpu))
    # The collapse's witness: the same test images through the model as
    # the CLI built it (--seed 0), before any step, against the dump.
    dataset = get_data_generator(DATASET, classes=list(range(100)))
    model, _ = common.build_embedding_model(100, "resnet-110-wfc", "inv_corr", 100, seed=0)
    before = common.extract_test_features(model.to(device), dataset, device, BATCH, pick=0)
    (std0, cos0), (std1, cos1) = feature_spread(before, emb), feature_spread(feats, emb)
    print(f"feature spread (mean per-dimension std; mean cosine to the mean class "
          f"embedding): before training {std0:.4g}, {cos0:.6f}; after 20 steps {std1:.4g}, "
          f"{cos1:.6f}")
    # nearest class centroid (the class embedding) and the model's softmax
    out = run_cli("evaluate_classification_accuracy", "--dataset", DATASET,
                  "--data_root", tmp, "--hierarchy", hierarchy, "--batch_size", str(BATCH),
                  "--model", model_path, "--label", "centroids", "--layer", "l2norm",
                  "--prob_features", "0", "--centroids", emb_path,
                  "--model", model_path, "--label", "prob", "--layer", "prob",
                  "--prob_features", "1", "--device", "cuda")
    accuracy = parse_table(out)
    check(sorted(accuracy) == ["centroids", "prob"] and all(
        0.0 <= v <= 1.0 for row in accuracy.values() for v in row.values()), accuracy)
    emb32 = emb.astype(np.float32)
    dists = ((feats ** 2).sum(1)[:, None] + (emb32 ** 2).sum(1)[None, :]
             - 2.0 * feats @ emb32.T)
    host_acc = float(np.mean(np.argsort(dists, axis=1, kind="stable")[:, 0]
                             == np.asarray(labels_test)))
    print(f"nearest-centroid accuracy {accuracy['centroids']['Accuracy']:.4f}, a host "
          f"argsort of the feature dump {host_acc:.4f}")
    check(f"{host_acc:.4f}" == f"{accuracy['centroids']['Accuracy']:.4f}", host_acc)
    return {"before_training": {"std": std0, "cos_to_mean_embedding": cos0},
            "after_20_steps": {"std": std1, "cos_to_mean_embedding": cos1}}


def topk_and_ranking_bitwise(device):
    """Phase 5c: the exact top-k and the ranked class ids of both ranking
    paths on the card, bitwise equal to the CPU's on tie-heavy inputs."""
    import torch

    from semantic_embeddings_torch.evaluation import retrieval as R
    from semantic_embeddings_torch.ops import topk as TK

    for case in TK.CHECK_CASES:
        x = TK.check_inputs(case)
        v, i = TK.exact_topk(x.to(device), case[2], chunk=case[3])
        v_cpu, i_cpu = TK.exact_topk(x, case[2], chunk=case[3])
        check(torch.equal(v.cpu(), v_cpu) and torch.equal(i.cpu(), i_cpu), f"top-k {case}")
    for prefix in (None, 250):
        ranked = R.ranking_check(device, prefix)
        check(torch.equal(ranked, R.ranking_check(torch.device("cpu"), prefix)),
              f"ranked class ids, prefix {prefix}")
    print(f"top-k at {TK.CHECK_CASES} (rows, n, k, chunk) and the ranked class ids of "
          "the full sort and the top-250 prefix: bitwise equal to the CPU")

# phase 12: (architecture, batch, --cls_base) trained through the CLI
ZOO_TRAIN = [("simple", 128, None), ("wrn-28-10", 128, "top"),
             ("pyramidnet-272-200", 128, None), ("densenet-bc-190-40", 64, None)]
NASNET_BATCH = 32
# warm steps timed for each family of 12b (img/s from the median step)
ZOO_TIMED_STEPS = 8


def timed(step, times):
    """``step`` with the seconds of each call (to the end of its device
    work) appended to ``times``."""
    import torch

    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    return run


def model_zoo(device, card, tmp, emb_path, embedding, labels, kernel_loss,
              plain_loss, reset_counts, read_counts, rn50_data, rn_prepare):
    """Phase 12: the model zoo at its published widths; see the module's
    docstring.  Returns the numbers for the JSON line."""
    import torch

    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.data import SyntheticDataset, get_data_generator
    from semantic_embeddings_torch.models import ARCHITECTURES, EmbeddingModel, build_network
    from semantic_embeddings_torch.models import nasnet as nasnet_module
    from semantic_embeddings_torch.ops import depthwise as dwc
    from semantic_embeddings_torch.train import (
        fit, get_lr_schedule, make_eval_step, make_train_step, new_train_state)

    def step_for(state, spec, prepare, loss_fn, autocast_dtype=None):
        """The CLI's --fused_loss train step (inv_corr + 0.1 cls head,
        clipnorm 10), with the cosine loss given."""
        return make_train_step(
            state.model.twin("linear", cls_input="l2norm"), prepare, loss_name="inv_corr",
            class_embedding=embedding, num_classes=100, cls_weight=0.1,
            l2_penalty_fn=spec.l2_penalty, clipnorm=10.0, loss_fn_override=loss_fn,
            autocast_dtype=autocast_dtype)

    def zoo_model(arch, cls_base=None):
        model, spec = common.build_embedding_model(100, arch, "inv_corr", 100, seed=0,
                                                   cls_base=cls_base)
        spec.l2_filters = [(r"^cls_top$", 5e-4)] + list(spec.l2_filters)  # as the CLI
        return common.init_model_state(model, device), spec

    out = {"params": {}, "train": {}}

    # -- 12a. every architecture at its input size ---------------------
    phase("12a build every architecture, eval forward at batch 2")
    builds = [(arch, {}) for arch in ARCHITECTURES] + [
        ("resnet-110-selu", {}), ("wrn-28-10", {"classification": True})]
    for arch, kw in builds:
        gen = torch.Generator(device=device).manual_seed(0)
        with torch.device(device):
            spec = build_network(100, arch, generator=gen, **kw)
            x = torch.randn(2, spec.input_size, spec.input_size, 3, generator=gen)
        module = spec.module.eval()
        with torch.no_grad():
            y = module(x)
        n = sum(p.numel() for p in module.parameters())
        name = arch + "".join(f" {k}" for k in kw)
        out["params"][name] = n
        print(f"{name}: {n:,} parameters, output {tuple(y.shape)} at "
              f"{spec.input_size} px, max |y| {y.abs().max().item():.4g}")
        check(y.shape == (2, module.out_features) and torch.isfinite(y).all().item(),
              (name, y.shape))
        if kw.get("classification"):
            check(torch.allclose(y.sum(-1), torch.ones(2, device=device)), "softmax top")
        del spec, module, x, y
    torch.cuda.empty_cache()

    # -- 12b. four families through the CLI, and one step in this process
    phase("12b simple / wrn-28-10 / pyramidnet-272-200 / densenet-bc-190-40 "
          "through learn_image_embeddings")
    for arch, batch, cls_base in ZOO_TRAIN:
        name = f"synthetic-100-{3 * batch}-{batch}"
        feat_path = os.path.join(tmp, f"{arch}.feat.pickle")
        model_path = os.path.join(tmp, f"{arch}.pt")
        printed = run_cli(
            "learn_image_embeddings", "--dataset", name, "--data_root", tmp,
            "--embedding", emb_path, "--architecture", arch, "--loss", "inv_corr",
            "--cls_weight", "0.1", "--fused_loss", "--lr_schedule", "SGDR",
            "--sgdr_max_lr", "0.5", "--batch_size", str(batch), "--epochs", "1",
            "--feature_dump", feat_path, "--model_dump", model_path,
            "--device", device.type, *(["--cls_base", cls_base] if cls_base else []))
        losses = re.findall(r"(\w*loss)['\"]?[=:] ?([^\s,}]+)", printed)
        check(len(losses) >= 4 and all(math.isfinite(float(v)) for _, v in losses),
              (arch, losses))
        with open(feat_path, "rb") as f:
            dump = pickle.load(f)["feat"]
        feats = np.stack([dump[i] for i in range(batch)])
        norms = np.linalg.norm(feats.astype(np.float64), axis=1)
        check(feats.shape == (batch, 100) and np.abs(norms - 1).max() <= 1e-5, (arch, norms))
        data = get_data_generator(name, classes=labels)
        rebuilt, meta = common.rebuild_model_from_checkpoint(model_path, device)
        check(meta.get("cls_base") == cls_base, meta)
        again = common.extract_test_features(rebuilt, data, device, batch, pick=0)
        dist = np.abs(again - feats).max()
        print(f"{arch}: {len(losses)} printed losses, all finite; {batch} unit-norm "
              f"features; the rebuilt dump reproduces them within {dist:.3g}")
        check(dist <= 1e-5, (arch, dist))
        del rebuilt
        if cls_base:
            run_cli("evaluate_classification_accuracy", "--dataset", name, "--data_root",
                    tmp, "--model", model_path, "--layer", "prob", "--prob_features", "1",
                    "--batch_size", str(batch), "--device", device.type)

        # one step through the cosine kernels and one through the plain
        # loss from the same weights and batch; then ZOO_TIMED_STEPS warm
        # steps, timed
        state_k, spec = zoo_model(arch, cls_base)
        state_p = copy.deepcopy(state_k)
        prepare = data.make_prepare(device)
        batches = list(data.train_batches(batch, 0, 0))
        reset_counts()
        _, m_k = step_for(state_k, spec, prepare, kernel_loss)(
            state_k, batches[0], 0.1, torch.Generator(device=device).manual_seed(0))
        counts = read_counts()
        _, m_p = step_for(state_p, spec, prepare, plain_loss)(
            state_p, batches[0], 0.1, torch.Generator(device=device).manual_seed(0))
        lk, lp = m_k["loss"].item(), m_p["loss"].item()
        rel = abs(lk - lp) / abs(lp)
        check(rel <= 1e-6, (arch, lk, lp))
        check(counts["cosine_loss_fwd"] == 1 and counts["cosine_loss_bwd"] == 1
              and counts["conv1x1_filter_grad"] == 0, counts)
        del state_p  # its blocks stay in the allocator's cache: the timed steps run warm
        torch.cuda.reset_peak_memory_stats()
        times = []
        step = timed(step_for(state_k, spec, prepare, kernel_loss), times)
        rng = torch.Generator(device=device).manual_seed(1)
        for i in range(ZOO_TIMED_STEPS):
            step(state_k, batches[1 + i % (len(batches) - 1)], 0.1, rng)
        rate = batch / float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**30
        out["train"][arch] = {"batch": batch, "img_per_s": rate, "peak_gib": peak,
                              "step_s": times,
                              "loss_kernel": lk, "loss_plain": lp,
                              "cosine_launches": counts["cosine_loss_fwd"]}
        print(f"{arch} step: loss kernel {lk:.9f} plain {lp:.9f} ({rel:.3g} relative), "
              f"cosine launches {counts['cosine_loss_fwd']} + {counts['cosine_loss_bwd']}; "
              f"{ZOO_TIMED_STEPS} warm steps {', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
              f"median {rate:.1f} img/s (f32, batch {batch}), peak {peak:.3f} GiB [{card}]")
        del state_k, batches, step
        torch.cuda.empty_cache()

    # -- 12c. NASNet-A at 224 px through fit ----------------------------
    phase(f"12c nasnet-a @ 224 px, batch {NASNET_BATCH}, 3 steps through fit (f32), "
          "one bf16 step")
    state, spec = zoo_model("nasnet-a")
    n_train = 3 * NASNET_BATCH
    data = SyntheticDataset(num_classes=100, n_train=n_train, n_test=NASNET_BATCH,
                            size=spec.input_size, classes=labels)
    prepare = data.make_prepare(device, augment_train=False)
    eval_step = make_eval_step(
        state.model, prepare, loss_name="inv_corr", class_embedding=embedding,
        num_classes=100, cls_weight=0.1, l2_penalty_fn=spec.l2_penalty)
    schedule, _ = get_lr_schedule("SGD", n_train, NASNET_BATCH)
    times = []
    tee = _Tee(sys.stdout)
    reset_counts()
    nasnet_module.depthwise_convs = 0
    dwc.launches_forward = dwc.launches_input_grad = dwc.launches_grad_weight = 0
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(tee):
        state = fit(state, timed(step_for(state, spec, prepare, kernel_loss), times),
                    eval_step, data, schedule, epochs=1, batch_size=NASNET_BATCH)
    counts = read_counts()
    fit_depthwise = nasnet_module.depthwise_convs
    dw_launches = (dwc.launches_forward, dwc.launches_input_grad, dwc.launches_grad_weight)
    # 220 depthwise convs a forward: the 3 steps' and the validation's, each
    # through the depthwise kernels (220 of each a forward and backward)
    check(fit_depthwise % 220 == 0 and fit_depthwise >= 3 * 220, fit_depthwise)
    check(dw_launches == (fit_depthwise, 3 * 220, 3 * 220), (dw_launches, fit_depthwise))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = re.findall(r"(\w*loss)['\"]?[=:] ?([^\s,}]+)", tee.buf.getvalue())
    check(state.step == 3 and counts["cosine_loss_fwd"] == 3
          and counts["cosine_loss_bwd"] == 3 and counts["conv1x1_filter_grad"] == 0,
          (state.step, counts))
    check(len(losses) >= 4 and all(math.isfinite(float(v)) for _, v in losses), losses)
    rate = NASNET_BATCH * 2 / sum(times[1:])
    torch.cuda.reset_peak_memory_stats()
    raw = next(iter(data.train_batches(NASNET_BATCH, 0, 0)))
    bf16_times = []
    nasnet_module.depthwise_convs = 0
    before16 = (dwc.launches_forward, dwc.launches_input_grad, dwc.launches_grad_weight)
    _, m16 = timed(step_for(state, spec, prepare, kernel_loss, torch.bfloat16), bf16_times)(
        state, raw, 0.01, torch.Generator(device=device).manual_seed(0))
    peak16 = torch.cuda.max_memory_allocated() / 2**30
    bf16_counts = read_counts()
    depthwise = nasnet_module.depthwise_convs
    check(depthwise == 220, depthwise)
    # bf16 under autocast keeps ATen's depthwise kernels
    check((dwc.launches_forward, dwc.launches_input_grad, dwc.launches_grad_weight) == before16,
          before16)
    check(math.isfinite(m16["loss"].item()) and bf16_counts["cosine_loss_fwd"] == 4
          and bf16_counts["conv1x1_filter_grad"] == 0, (m16["loss"], bf16_counts))
    out["nasnet"] = {"batch": NASNET_BATCH, "params": sum(p.numel() for p in state.params),
                     "step_s": times, "img_per_s": rate, "peak_gib": peak,
                     "bf16_step_s": bf16_times[0], "bf16_loss": m16["loss"].item(),
                     "bf16_peak_gib": peak16, "cosine_launches": bf16_counts["cosine_loss_fwd"],
                     "depthwise_convs_per_forward": depthwise,
                     "depthwise_convs_fit": fit_depthwise,
                     "depthwise_kernel_launches_fit": dw_launches}
    print(f"nasnet-a: {out['nasnet']['params']:,} parameters; {len(losses)} printed losses, "
          f"all finite; steps {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; steps 2-3 "
          f"{rate:.1f} img/s (f32, batch {NASNET_BATCH}), peak {peak:.3f} GiB; bf16 step "
          f"{bf16_times[0] * 1e3:.1f} ms, loss {m16['loss'].item():.6f}, peak {peak16:.3f} GiB; "
          f"cosine launches {bf16_counts['cosine_loss_fwd']} + "
          f"{bf16_counts['cosine_loss_bwd']}; depthwise convs {depthwise} a forward "
          f"({fit_depthwise} through fit; kernel launches forward / input grad / weight grad "
          f"{dw_launches}) [{card}]")
    del state, eval_step, data, prepare
    torch.cuda.empty_cache()

    # -- 12d. --remat on ResNet-50 ----------------------------------------
    phase(f"12d resnet-50 @ 224 px, batch {RN50_BATCH}: a step with --remat vs without (f32)")
    states = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(3)
        spec = build_network(100, "resnet-50", generator=gen, remat=remat)
        spec.l2_filters = [(r"^cls_top$", 5e-4)]
        model = EmbeddingModel(spec.module, output="l2norm", cls_classes=100, generator=gen)
        states[remat] = (new_train_state(model.to(device)), spec)
    before = copy.deepcopy(states[False][0].model.state_dict())
    for key, value in states[True][0].model.state_dict().items():
        check(torch.equal(value, before[key]), f"remat model differs at {key}")
    raw = next(iter(rn50_data.train_batches(RN50_BATCH, 0, 0)))
    runs = {}
    # cuDNN's default algorithms may sum with atomics, so that two runs of
    # the same step differ by an ulp (the stem's filter gradient has, on
    # the H100); deterministic ones make the two steps comparable
    torch.backends.cudnn.deterministic = True
    for remat, (state, spec) in states.items():
        reset_counts()
        _, metrics = step_for(state, spec, rn_prepare, kernel_loss)(state, raw, 0.1, None)
        runs[remat] = {"loss": metrics["loss"].item(), "launches": read_counts()}
    plain_sd, remat_sd = (states[k][0].model.state_dict() for k in (False, True))
    param_names = {n for n, _ in states[False][0].model.named_parameters()}
    stats_differ = [k for k in before if k not in param_names
                    and not torch.equal(remat_sd[k], plain_sd[k])]
    far, equal, worst = [], 0, 0.0
    for key in param_names:
        update = (plain_sd[key] - before[key]).abs().max().item()
        diff = (remat_sd[key] - plain_sd[key]).abs().max().item()
        equal += diff == 0.0
        worst = max(worst, diff / max(update, 1e-30))
        if diff > 1e-6 * update:
            far.append((key, diff, update))
    # a second step of each, for its time and peak memory, with the
    # allocator's cache kept warm (emptying it puts cudaMalloc in the step)
    for remat, (state, spec) in states.items():
        step = step_for(state, spec, rn_prepare, kernel_loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        timed(step, times)(state, raw, 0.1, None)
        runs[remat].update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           step_s=times[0])
    torch.backends.cudnn.deterministic = False
    loss_rel = abs(runs[True]["loss"] - runs[False]["loss"]) / abs(runs[False]["loss"])
    lr, lp = runs[True]["launches"], runs[False]["launches"]
    print(f"remat vs plain (cuDNN deterministic): loss {runs[True]['loss']:.9f} / "
          f"{runs[False]['loss']:.9f} ({loss_rel:.3g} relative); running statistics "
          f"{len(before) - len(param_names) - len(stats_differ)} of "
          f"{len(before) - len(param_names)} bitwise equal; parameters {equal} of "
          f"{len(param_names)} bitwise equal, worst {worst:.3g} of its update; "
          f"conv3x3_bn_stats launches {lr['conv3x3_bn_stats']} / {lp['conv3x3_bn_stats']}, "
          f"conv3x3_filter_grad {lr['conv3x3_filter_grad']} / {lp['conv3x3_filter_grad']}, "
          f"conv1x1_filter_grad {lr['conv1x1_filter_grad']} / {lp['conv1x1_filter_grad']}; "
          f"second step: peak memory {runs[True]['peak_gib']:.3f} / "
          f"{runs[False]['peak_gib']:.3f} GiB, {runs[True]['step_s'] * 1e3:.1f} / "
          f"{runs[False]['step_s'] * 1e3:.1f} ms (f32, batch {RN50_BATCH}) [{card}]")
    check(not stats_differ, f"running statistics differ under remat: {stats_differ[:5]}")
    check(not far, f"parameters farther than 1e-6 of their update: {far[:5]}")
    check(loss_rel <= 1e-6, runs)
    check(lr["conv3x3_bn_stats"] == 2 * RN50_CONVS and lp["conv3x3_bn_stats"] == RN50_CONVS
          and lr["conv3x3_filter_grad"] == RN50_CONVS
          and lp["conv3x3_filter_grad"] == RN50_CONVS
          and lr["conv1x1_filter_grad"] == lp["conv1x1_filter_grad"] == RN50_1X1, (lr, lp))
    check(runs[True]["peak_gib"] < runs[False]["peak_gib"], runs)
    out["remat"] = {"remat": runs[True], "plain": runs[False], "worst_of_update": worst}
    del states, before, plain_sd, remat_sd
    torch.cuda.empty_cache()
    return out


# phase 13: the classifier recipe's batch (CosineLoss.md / RECIPES.md), the
# steps of one epoch and its validation batches
CLS_BATCH, CLS_STEPS, CLS_VAL = 24, 4, 2
# phase 13d: the baselines at slice 1's shape, 5 steps of 100
BASE_DATASET, BASE_STEPS = "synthetic-100-500-200", 5
# warm steps timed for each learner of 13c and 13d
LEARNER_TIMED_STEPS = 5


def run_clis(jobs):
    """Runs ``{name: (module, argv)}`` CLIs of the port, each in its own
    process, all at once; returns ``{name: stdout}``.  Fails unless every
    one exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"semantic_embeddings_torch.cli.{module}", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (module, argv) in jobs.items()}
    outs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        print(f"{name} ({jobs[name][0]}) exit {proc.returncode}, done at "
              f"{time.perf_counter() - t0:.1f} s\n{stdout.strip()}")
        if proc.returncode:
            print(stderr[-4000:])
        outs[name] = (proc.returncode, stdout)
    check(all(code == 0 for code, _ in outs.values()),
          {name: code for name, (code, _) in outs.items()})
    return {name: out for name, (_, out) in outs.items()}


def finite_losses(name, printed):
    """Fails unless every loss a CLI printed (training and validation) is
    finite; returns how many it printed."""
    losses = re.findall(r"(\w*loss)['\"]?[=:] ?([^\s,}]+)", printed)
    check(len(losses) >= 2 and all(math.isfinite(float(v)) for _, v in losses),
          (name, losses))
    return len(losses)


def finite_train_losses(name, printed):
    """Fails unless each epoch's training loss (``loss=`` on the epoch
    lines) is finite; returns them, with the validation losses printed."""
    train = [float(v) for v in re.findall(r"^epoch .* loss=([^\s]+)", printed, re.M)]
    check(train and all(math.isfinite(v) for v in train), (name, train))
    val = [float(v) for v in re.findall(r"'val_loss': ([^\s,}]+)", printed)]
    return train, val


#: an image whose float64 forward reaches this magnitude in some layer of the
#: backbone (1e-3 of float32's largest value) may give non-finite float32
#: features; below it every feature must be finite
F32_RANGE_MARGIN = float(np.finfo(np.float32).max) * 1e-3


def exact_features(model, data, device, batch):
    """The eval-mode features of every test image through a float64 copy of
    ``model``, and for each image the largest magnitude that any module of
    the backbone produced on the way (float32 overflows where that passes
    its range, and the features then turn inf or NaN)."""
    import torch

    from semantic_embeddings_torch.cli import common

    exact = copy.deepcopy(model).double().eval()
    peak = {}

    def record(module, inputs, output):
        if torch.is_tensor(output):
            peak["now"] = torch.maximum(peak["now"], output.abs().flatten(1).amax(1))

    handles = [m.register_forward_hook(record) for m in exact.backbone.modules()]
    prepare = data.make_prepare(device)
    rng = torch.Generator(device=device).manual_seed(0)
    feats, peaks, valids = [], [], []
    try:
        with torch.no_grad():
            for raw in data.test_batches(batch):
                images, _ = prepare(raw, rng, False)
                images = images.double()
                peak["now"] = images.abs().flatten(1).amax(1)
                feats.append(common.forward_tap(exact, images, None, 0))
                peaks.append(peak["now"])
                valids.append(np.asarray(raw["valid"]) > 0 if "valid" in raw
                              else np.ones(len(images), dtype=bool))
    finally:
        for handle in handles:
            handle.remove()
    valid = np.concatenate(valids)
    return torch.cat(feats).cpu().numpy()[valid], torch.cat(peaks).cpu().numpy()[valid]


def time_learner(name, step, state, batches, card):
    """Times LEARNER_TIMED_STEPS warm steps of ``step``; returns the median
    step's seconds and the peak device memory."""
    import torch

    rng = torch.Generator(device=next(state.model.parameters()).device).manual_seed(0)
    step(state, batches[0], 0.01, rng)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    run = timed(step, times)
    for i in range(LEARNER_TIMED_STEPS):
        run(state, batches[(1 + i) % len(batches)], 0.01, rng)
    step_s = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name}: {LEARNER_TIMED_STEPS} warm steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms, median {step_s * 1e3:.1f} ms, "
          f"peak {peak:.3f} GiB [{card}]")
    return {"step_s": times, "median_step_ms": step_s * 1e3, "peak_gib": peak}


def phase13(device, card, tmp, rn50_ckpt, emb_path, embedding, slice1_dump, CC,
            reset_counts, read_counts):
    """Phase 13: export and artifact serving, the classifier, --finetune and
    the baselines; see the module's docstring.  Returns the numbers for the
    JSON line."""
    import torch

    from semantic_embeddings_torch.cli import (
        common, export_model, learn_classifier, learn_image_embeddings)
    from semantic_embeddings_torch.data import get_data_generator
    from semantic_embeddings_torch.train import (
        losses, make_classifier_train_step, make_train_step, new_train_state, special)

    out = {"export": {}}
    t_phase = time.perf_counter()

    # -- 13e (first: it is short). dispatch through the ops, host time -----
    phase("13e host time a call: each custom op against its kernel's wrapper called directly")
    from semantic_embeddings_torch.ops import checks
    from semantic_embeddings_torch.ops import cosine_loss as C

    gen = torch.Generator(device=device).manual_seed(0)
    z, t, g = C.check_inputs((BATCH, 100), torch.float32, gen)
    x, w, dy = checks.conv3x3_check_inputs((2, 7, 7, 32, 32), torch.float32, gen)
    ops = torch.ops.semantic_embeddings_torch
    pairs = {
        "cosine_loss_fwd": (lambda: ops.cosine_loss_fwd(z, t), lambda: C._launch_forward(z, t)),
        "cosine_loss_bwd": (lambda: ops.cosine_loss_bwd(z, t, g),
                            lambda: C._launch_backward(z, t, g)),
        "conv3x3_bn_stats": (lambda: ops.conv3x3_bn_stats(x, w),
                             lambda: CC._launch_conv_bn_stats(x, w)),
        "conv3x3_filter_grad": (lambda: ops.conv3x3_filter_grad(x, dy),
                                lambda: CC._launch_filter_grad(x, dy)),
    }

    def host_us(fn, n=500):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    dispatch = {}
    for name, (op, direct_fn) in pairs.items():
        runs = {"direct": [], "op": []}
        for kind in ("direct", "op", "op", "direct"):
            runs[kind].append(host_us(direct_fn if kind == "direct" else op))
        d, o = statistics.mean(runs["direct"]), statistics.mean(runs["op"])
        dispatch[name] = {"direct_us": runs["direct"], "op_us": runs["op"],
                          "dispatch_us": o - d}
        print(f"{name}: {o:.1f} us a call through the op, {d:.1f} us through the wrapper "
              f"directly (small shapes, launch-bound): dispatch {o - d:.1f} us [{card}]")
    per_step = {"slice1": dispatch["cosine_loss_fwd"]["dispatch_us"]
                + dispatch["cosine_loss_bwd"]["dispatch_us"],
                "resnet50": RN50_CONVS * (dispatch["conv3x3_bn_stats"]["dispatch_us"]
                                          + dispatch["conv3x3_filter_grad"]["dispatch_us"])
                + dispatch["cosine_loss_fwd"]["dispatch_us"]
                + dispatch["cosine_loss_bwd"]["dispatch_us"]}
    print(f"dispatch a train step: slice 1 {per_step['slice1']:.1f} us (2 op calls), "
          f"resnet-50 {per_step['resnet50']:.1f} us (34 op calls) [{card}]")
    out["dispatch"] = {"per_call": dispatch, "per_step_us": per_step}
    del z, t, g, x, w, dy

    # -- 13a. export_model in its own process, f32 and bf16 ---------------
    phase("13a export phase 8's resnet-50 (export_model --validate, own processes), "
          "f32 and bf16, batch -1, l2norm")
    paths = {p: os.path.join(tmp, f"resnet50_{p}.pt2") for p in ("f32", "bf16")}
    printed = run_clis({p: ("export_model", [
        "--checkpoint", rn50_ckpt, "--out", path, "--layer", "l2norm", "--input_size",
        str(SERVE_SIZE), "--batch", "-1", "--device", device.type, "--validate",
        *(["--bf16"] if p == "bf16" else [])]) for p, path in paths.items()})
    direct, _ = common.rebuild_model_from_checkpoint(rn50_ckpt, device)
    gen = torch.Generator(device=device).manual_seed(13)
    for precision, path in paths.items():
        check("Validated" in printed[precision], f"{precision} export not validated")
        export_s = float(re.search(r"in ([0-9.]+) s; custom-op", printed[precision]).group(1))
        nodes = export_model.count_op_nodes(torch.export.load(path), "conv3x3_bn_stats")
        check(nodes == RN50_CONVS, f"{precision} artifact holds {nodes} conv3x3_bn_stats nodes")
        fn, sidecar = export_model.load_artifact(path, device)
        bf16 = torch.bfloat16 if precision == "bf16" else None
        result = {"export_s": export_s, "conv3x3_bn_stats_nodes": nodes,
                  "bytes": os.path.getsize(path), "launches_per_call": {}, "max_abs_err": {}}
        for b in (1, 64):
            x = torch.randn(b, SERVE_SIZE, SERVE_SIZE, 3, generator=gen, device=device)
            reset_counts()
            with torch.inference_mode():
                got = fn(x)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts["conv1x1_filter_grad"] == 0, counts)
            result["launches_per_call"][b] = counts["conv3x3_bn_stats"]
            with torch.inference_mode(), common.maybe_autocast(device, bf16):
                want = common.forward_tap(direct, x, "l2norm").float()
            err = (got - want).abs().max().item()
            result["max_abs_err"][b] = err
            if bf16 is None:
                check(err <= 1e-5, f"f32 artifact vs direct forward at batch {b}: {err:.3g}")
            else:  # the JAX export CLI's bf16 tolerance
                torch.testing.assert_close(got, want, rtol=2e-2, atol=1e-3)
        check(result["launches_per_call"] == {1: RN50_CONVS, 64: RN50_CONVS},
              result["launches_per_call"])
        def direct_call():
            with common.maybe_autocast(device, bf16):
                return common.forward_tap(direct, x, "l2norm")

        with torch.inference_mode():  # in turns: artifact, direct, direct, artifact
            for key, call in (("call", lambda: fn(x)), ("direct", direct_call),
                              ("direct", direct_call), ("call", lambda: fn(x))):
                result.setdefault(f"{key}_ms_b64", []).append(time_ms(call, iters=20,
                                                                      warmup=3))
        out["export"][precision] = result
        print(f"{precision} artifact: exported in {export_s:.2f} s ({result['bytes']:,} "
              f"bytes), {nodes} conv3x3_bn_stats nodes, {RN50_CONVS} launches a call at "
              f"batch 1 and 64; vs the direct forward {result['max_abs_err']}; a call at "
              f"batch 64 {result['call_ms_b64']} ms, the direct forward "
              f"{result['direct_ms_b64']} ms (CUDA events, in turns) [{card}]")
        del fn
    del direct
    torch.cuda.empty_cache()

    # -- 13b. serve the f32 artifact over HTTP ---------------------------
    phase("13b serve the f32 artifact over HTTP (serve_model --artifact)")
    out["serving"] = serve_resnet50(rn50_ckpt, device, card, CC, reset_counts, read_counts,
                                    artifact=paths["f32"])
    torch.cuda.empty_cache()

    # -- 13c. the classifier recipe, its dump, --finetune from it --------
    phase(f"13c learn_classifier: resnet-50 @ {SERVE_SIZE} px, --label_smoothing 0.1, SGDR, "
          f"batch {CLS_BATCH}, --bf16; then learn_image_embeddings --finetune")
    name = f"synthetic-100-{CLS_STEPS * CLS_BATCH}-{CLS_VAL * CLS_BATCH}-{SERVE_SIZE}"
    cls_dump = os.path.join(tmp, "classifier.pt")
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        state = learn_classifier.main([
            "--dataset", name, "--data_root", tmp, "--architecture", "resnet-50",
            "--label_smoothing", "0.1", "--lr_schedule", "SGDR", "--sgdr_max_lr", "0.05",
            "--batch_size", str(CLS_BATCH), "--bf16", "--epochs", "1",
            "--model_dump", cls_dump, "--device", device.type])
    torch.cuda.synchronize()
    counts = read_counts()
    finite_losses("learn_classifier", tee.buf.getvalue())
    # fit's validation and the final one each run the CLS_VAL test batches
    want = {"cosine_loss_fwd": 0, "cosine_loss_bwd": 0,
            "conv3x3_bn_stats": RN50_CONVS * (CLS_STEPS + 2 * CLS_VAL),
            "conv3x3_filter_grad": RN50_CONVS * CLS_STEPS, "conv1x1_filter_grad": 0}
    check(state.step == CLS_STEPS and counts == want, (state.step, counts))
    data = get_data_generator(name)
    batches = list(data.train_batches(CLS_BATCH, 0, 0))
    out["classifier"] = {"launches": counts, **time_learner(
        f"learn_classifier step (resnet-50, bf16, batch {CLS_BATCH})",
        make_classifier_train_step(state.model, data.make_prepare(device),
                                   num_classes=data.num_classes,
                                   label_smoothing=0.1, autocast_dtype=torch.bfloat16),
        state, batches, card)}
    del state
    torch.cuda.empty_cache()
    table = run_cli("evaluate_classification_accuracy", "--dataset", name, "--data_root",
                    tmp, "--model", cls_dump, "--layer", "prob", "--prob_features", "1",
                    "--batch_size", str(CLS_BATCH), "--device", device.type)
    accuracy = parse_table(table)["classifier"]
    check(all(0.0 <= v <= 1.0 for v in accuracy.values()), accuracy)
    out["classifier"]["evaluate_classification_accuracy"] = accuracy

    dump = torch.load(cls_dump, map_location="cpu", weights_only=True)["model"]
    phase1 = {}
    finetune = common.finetune

    def finetune_checked(args, state, warm_step, eval_step, dataset):
        tops = {n: p.detach().clone() for n, p in state.model.named_parameters()
                if "top" in n}
        reset_counts()
        state = finetune(args, state, warm_step, eval_step, dataset)
        torch.cuda.synchronize()
        phase1["launches"] = read_counts()
        params = dict(state.model.named_parameters())
        loaded = [k for k in dump if "backbone." + k in params and not k.startswith("top.")]
        phase1["backbone_params_checked"] = len(loaded)
        phase1["backbone_changed"] = [k for k in loaded
                                      if not torch.equal(params["backbone." + k].cpu(), dump[k])]
        phase1["tops_moved"] = {n: not torch.equal(params[n], v) for n, v in tops.items()}
        reset_counts()
        return state

    common.finetune = finetune_checked
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            state = learn_image_embeddings.main([
                "--dataset", name, "--data_root", tmp, "--embedding", emb_path,
                "--architecture", "resnet-50", "--loss", "inv_corr", "--cls_weight", "0.1",
                "--fused_loss", "--lr_schedule", "SGDR", "--sgdr_max_lr", "0.05",
                "--batch_size", str(CLS_BATCH), "--bf16", "--epochs", "1",
                "--finetune", cls_dump, "--finetune_init", "1", "--device", device.type])
    finally:
        common.finetune = finetune
    torch.cuda.synchronize()
    phase2 = read_counts()
    finite_losses("learn_image_embeddings --finetune", tee.buf.getvalue())
    check(phase1["backbone_params_checked"] == len(
        [n for n, _ in state.model.backbone.named_parameters() if not n.startswith("top.")])
        and not phase1["backbone_changed"], phase1)
    check(all(phase1["tops_moved"].values()), phase1["tops_moved"])
    check(phase1["launches"] == {
        "cosine_loss_fwd": CLS_STEPS, "cosine_loss_bwd": CLS_STEPS,
        "conv3x3_bn_stats": RN50_CONVS * (CLS_STEPS + CLS_VAL),
        "conv3x3_filter_grad": 0, "conv1x1_filter_grad": 0}, phase1["launches"])
    check(phase2 == {
        "cosine_loss_fwd": CLS_STEPS, "cosine_loss_bwd": CLS_STEPS,
        "conv3x3_bn_stats": RN50_CONVS * (CLS_STEPS + 2 * CLS_VAL),
        "conv3x3_filter_grad": RN50_CONVS * CLS_STEPS, "conv1x1_filter_grad": 0}, phase2)
    print(f"--finetune phase 1: {phase1['backbone_params_checked']} backbone parameters "
          f"bitwise as loaded (the BN running statistics move, as in Keras 2.2), tops "
          f"moved {phase1['tops_moved']}, launches {phase1['launches']}; phase 2 launches "
          f"{phase2}")
    out["finetune"] = {"phase1": phase1, "phase2_launches": phase2}
    del state
    torch.cuda.empty_cache()

    # -- 13d. the baselines on resnet-110-wfc, each in its own process ----
    phase(f"13d learn_devise / learn_labelembedding / learn_center_loss (learned and "
          f"fixed): resnet-110-wfc @ 32 px, batch {BATCH}, own processes")
    base = ["--dataset", BASE_DATASET, "--data_root", tmp, "--architecture",
            "resnet-110-wfc", "--batch_size", str(BATCH), "--device", device.type]
    learners = {
        "devise": ("learn_devise", ["--embedding", emb_path, "--init_weights", slice1_dump,
                                    "--init_epochs", "1", "--ft_epochs", "1"]),
        "labelembed": ("learn_labelembedding", ["--embed_dim", "100", "--epochs", "1",
                                                "--lr_schedule", "SGDR"]),
        "center_loss": ("learn_center_loss", ["--embed_dim", "100", "--epochs", "1"]),
        "center_loss_fixed": ("learn_center_loss", ["--centroids", emb_path, "--epochs", "1"]),
    }
    files = {k: (os.path.join(tmp, f"{k}.pt"), os.path.join(tmp, f"{k}.feat.pickle"))
             for k in learners}
    printed = run_clis({k: (module, [*base, *argv, "--model_dump", files[k][0],
                                     "--feature_dump", files[k][1]])
                        for k, (module, argv) in learners.items()})
    data = get_data_generator(BASE_DATASET)
    batches = list(data.train_batches(BATCH, 0, 0))
    prepare = data.make_prepare(device)
    norm_emb = embedding / np.linalg.norm(embedding, axis=-1, keepdims=True)
    out["baselines"] = {}
    for k, (model_path, feat_path) in files.items():
        # After 5 steps the BatchNorm running statistics are still 95% their
        # initial (0, 1), so in eval mode the 54 residual blocks scale the
        # raw embeddings without bound (no l2norm here, unlike slice 1):
        # validation losses may overflow; the training losses may not.  The
        # features may overflow float32 too, and then only where the float64
        # forward of the same weights passes float32's range.
        train_losses, val_losses = finite_train_losses(k, printed[k])
        with open(feat_path, "rb") as f:
            feats_dump = pickle.load(f)["feat"]
        feats = np.stack([feats_dump[i] for i in range(len(feats_dump))])
        model, meta = common.rebuild_model_from_checkpoint(model_path, device)
        again = common.extract_test_features(model, data, device, BATCH, pick=0)
        # the rebuilt dump within 1e-5 of each feature's size (at least 1),
        # NaN where the dump has NaN
        same = ((again == feats) | (np.isnan(again) & np.isnan(feats))
                | (np.abs(again - feats) <= 1e-5 * np.maximum(1.0, np.abs(feats))))
        finite = np.isfinite(feats)
        dist = float(np.abs(again - feats)[finite].max()) if finite.any() else 0.0
        # the dump against the float64 forward: rows in float32's range are
        # finite and within 1e-5 of the row's largest magnitude
        exact, peak = exact_features(model, data, device, BATCH)
        in_range = peak < F32_RANGE_MARGIN
        scale = np.maximum(np.abs(exact).max(axis=1, keepdims=True), np.finfo(np.float64).tiny)
        rows = feats[in_range]
        vs_f64 = float((np.abs(rows - exact[in_range]) / scale[in_range]).max()) \
            if in_range.any() else 0.0
        check(feats.shape == (data.num_test, 100) and same.all()
              and np.isfinite(rows).all() and vs_f64 <= 1e-5,
              (k, feats.shape, dist, vs_f64, int((~in_range).sum())))
        if k == "center_loss_fixed":
            check(np.array_equal(model.cls_centroids.detach().cpu().numpy(), embedding),
                  "the fixed centroids moved")
        state = new_train_state(model.train())
        if k == "devise":
            step = make_train_step(model, prepare, class_embedding=norm_emb,
                                   loss_fn_override=losses.devise_ranking_loss(norm_emb),
                                   optimizer="adagrad", clipnorm=0.0)
        elif k == "labelembed":
            step = special.make_labelembed_train_step(model, prepare)
        else:
            step = special.make_center_loss_train_step(
                model, prepare, num_classes=data.num_classes,
                trainable_fn=(lambda p: "cls_centroids" not in p)
                if k == "center_loss_fixed" else None)
        out["baselines"][k] = {"train_losses": train_losses, "val_losses": val_losses,
                               "rebuilt_vs_dump": dist,
                               "finite_features": float(finite.mean()),
                               "vs_f64_of_row_max": vs_f64,
                               "rows_past_f32_range": int((~in_range).sum()),
                               "f64_peak": float(peak.max()),
                               **time_learner(f"{k} step (resnet-110-wfc, f32, batch {BATCH})",
                                              step, state, batches, card)}
        print(f"{k}: training losses {train_losses} (finite), validation losses "
              f"{val_losses}; the rebuilt dump reproduces its {feats.shape} features "
              f"({finite.mean():.3f} of them finite) within {dist:.3g}; the float64 forward "
              f"reaches {peak.max():.3g} ({int((~in_range).sum())} of {len(peak)} images past "
              f"float32's range), the rest within {vs_f64:.3g} of their rows' largest")
        del model, state, step
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13 took {out['seconds']:.1f} s")
    return out


# phase 14: the file datasets on the CosineLoss.md CUB recipe (ResNet-50 at
# 448 px, batch 24, bf16): 200 classes of CUB's layout, 3 training and 1 test
# images each, shorter sides of 300-500 px
CUB_CLASSES, CUB_TRAIN, CUB_TEST, CUB_BATCH = 200, 3, 1, 24
CUB_ARCH = "resnet-50"
CUB_EPOCHS = 2
#: images decoded per timed call of the host transform (14c)
DECODE_IMAGES = 96
#: the host threads of the file pipeline (the CLI's --read_workers)
READ_WORKERS = 8
#: the 14h cut: this many classes of 14b's files (symlinks) for each recipe
SUB_CLASSES = 50


def probe_host():
    """The decode plan's inputs: libjpeg's header and libraries, Pillow,
    nvJPEG's header, the cores; and whether the native decoder builds.
    Returns ``(probe, plan, build_error)``: plan A (the native decoder
    builds), B (it does not, Pillow is present) or C (neither)."""
    import shutil

    from semantic_embeddings_torch import native

    probe = {"jpeglib.h": os.path.exists("/usr/include/jpeglib.h")}
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    probe["ldconfig"] = [line.strip() for line in ldconfig.splitlines()
                         if "libjpeg" in line or "libnvjpeg" in line]
    try:
        import PIL

        probe["pillow"] = PIL.__version__
    except ImportError:
        probe["pillow"] = None
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    header = os.path.normpath(os.path.join(os.path.dirname(nvcc), "..", "include", "nvjpeg.h"))
    probe["nvjpeg.h"] = header if os.path.exists(header) else None
    probe["nproc"] = os.cpu_count()
    probe["affinity"] = len(os.sched_getaffinity(0))
    try:
        native.loader()
        build_error = None
    except RuntimeError as e:
        build_error = str(e)
    plan = "A" if build_error is None else ("B" if probe["pillow"] else "C")
    return probe, plan, build_error


def write_cub(root, seed=0):
    """A CUB-200-2011 layout from ``seed``: ``images/<class>/<n>.jpg``,
    ``images.txt``, ``image_class_labels.txt``, ``train_test_split.txt`` and
    ``classes.txt``; CUB_CLASSES classes of CUB_TRAIN + CUB_TEST images,
    shorter sides of 300-500 px and aspects of 0.75-1.33 (CUB's photos),
    each a class template (12 x 12 colors, so that the classes differ and
    the loss can fall) with the image's own noise, upsampled; the first
    image grayscale.  Written with Pillow, in threads."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    templates = rng.integers(30, 225, (CUB_CLASSES, 12, 12, 3))
    jobs, lines = [], {"images": [], "labels": [], "split": [], "classes": []}
    i = 0
    for c in range(1, CUB_CLASSES + 1):
        folder = f"{c:03d}.Species_{c}"
        lines["classes"].append(f"{c} {folder}")
        for k in range(CUB_TRAIN + CUB_TEST):
            i += 1
            short, aspect = int(rng.integers(300, 501)), float(rng.uniform(0.75, 1.33))
            w, h = ((round(short * aspect), short) if aspect >= 1
                    else (short, round(short / aspect)))
            small = np.clip(templates[c - 1] + rng.integers(-30, 31, (12, 12, 3)), 0, 255)
            fn = f"{folder}/{folder.split('.')[1]}_{k:04d}.jpg"
            jobs.append((os.path.join(root, "images", fn), small.astype(np.uint8), (w, h),
                         i == 1))
            lines["images"].append(f"{i} {fn}")
            lines["labels"].append(f"{i} {c}")
            lines["split"].append(f"{i} {1 if k < CUB_TRAIN else 0}")

    def write(job):
        path, small, size, gray = job
        os.makedirs(os.path.dirname(path), exist_ok=True)
        img = Image.fromarray(small).resize(size, Image.BILINEAR)
        (img.convert("L") if gray else img).save(path, quality=90)
        return os.path.getsize(path)

    with ThreadPoolExecutor(READ_WORKERS) as pool:
        nbytes = sum(pool.map(write, jobs))
    for name, key in (("images.txt", "images"), ("image_class_labels.txt", "labels"),
                      ("train_test_split.txt", "split"), ("classes.txt", "classes")):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines[key]) + "\n")
    return len(jobs), nbytes


def write_subset(src, dst, n_classes):
    """A copy of ``src``'s layout with its first ``n_classes`` classes, the
    image files as symlinks into ``src``."""
    os.makedirs(os.path.join(dst, "images"), exist_ok=True)
    keep = set(range(1, n_classes + 1))
    with open(os.path.join(src, "image_class_labels.txt")) as f:
        ids = {line.split()[0] for line in f if int(line.split()[1]) in keep}
    for name in ("images.txt", "image_class_labels.txt", "train_test_split.txt"):
        with open(os.path.join(src, name)) as f, open(os.path.join(dst, name), "w") as g:
            g.writelines(line for line in f if line.split()[0] in ids)
    for entry in sorted(os.listdir(os.path.join(src, "images")))[:n_classes]:
        os.symlink(os.path.join(src, "images", entry), os.path.join(dst, "images", entry))


def write_taxonomy_cub(path):
    """A two-level tree over CUB's 200 class ids: root 1000, 20 superclasses
    500..519, ten leaves each (1..200)."""
    with open(path, "w") as f:
        for s in range(20):
            f.write(f"1000 {500 + s}\n")
            for leaf in range(10):
                f.write(f"{500 + s} {10 * s + leaf + 1}\n")


def decode_rates(root, decoder, card):
    """Host decode rates of CUB's transforms through ``FileDataset._compose``
    (the pipeline's own host work, no prefetch): the test transform
    (shorter side 512, center crop 448) and the train transform (random
    crop), on 1 thread and on READ_WORKERS threads, DECODE_IMAGES images a
    call, the best of 2 calls.  Returns ``{transform: {threads: img/s}}``."""
    from semantic_embeddings_torch.data import get_data_generator

    ds = get_data_generator("cub", root)
    ds.use_native = decoder == "native"
    rates = {}
    for transform, files, train in (("test", ds.test_img_files, False),
                                    ("train", ds.train_img_files, True)):
        files = list(files[:DECODE_IMAGES])
        for threads in (1, READ_WORKERS):
            ds.read_workers, ds._pool = threads, None
            seconds = []
            for k in range(2):
                t0 = time.perf_counter()
                batch = ds._compose(files, train, np.random.default_rng(k))
                seconds.append(time.perf_counter() - t0)
            check(batch.shape == (len(files), 448, 448, 3), batch.shape)
            rates.setdefault(transform, {})[threads] = len(files) / min(seconds)
            print(f"decode {decoder} {transform} transform, {threads} thread(s): "
                  f"{len(files) / min(seconds):.1f} img/s (calls "
                  + ", ".join(f"{s:.3f}" for s in seconds) + f" s)  [{card}]")
    return rates


def composite_rate(state, step, ds, device, card, epoch, n_warm=5, n_profiled=8):
    """Train steps fed by the file pipeline (prefetch thread, host decode,
    pinned copy): the img/s of the steps after ``n_warm`` over one epoch,
    then ``n_profiled`` more under ``torch.profiler`` for the device's busy
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator(device=device).manual_seed(0)
    n_warm = min(n_warm, ds.steps_per_epoch(CUB_BATCH) // 4)
    n = 0
    for n, raw in enumerate(ds.train_batches(CUB_BATCH, epoch, 0)):
        if n == n_warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        step(state, raw, 0.01, rng)
    torch.cuda.synchronize()
    timed_steps = n + 1 - n_warm
    wall = (time.perf_counter() - t0) / timed_steps * 1e3
    batches = ds.train_batches(CUB_BATCH, epoch + 1, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, raw in zip(range(n_profiled), batches):
            step(state, raw, 0.01, rng)
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) / n_profiled * 1e3
    batches.close()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(kernels, "torch.profiler recorded no GPU kernel")
    device_ms = sum(e.self_device_time_total for e in kernels) / n_profiled / 1e3
    # busy share as profile_step takes it: device time over the wall time
    # without the profiler (which slows the host's side of the step)
    out = {"wall_ms": wall, "img_per_s": CUB_BATCH / wall * 1e3, "timed_steps": timed_steps,
           "profiled_wall_ms": profiled_wall, "device_ms": device_ms,
           "busy": device_ms / wall, "busy_under_profiler": device_ms / profiled_wall}
    print(f"composite (file pipeline, {ds.read_workers} read workers, "
          f"{'native' if ds.use_native else 'Pillow'} decoder): {wall:.2f} ms/step "
          f"({out['img_per_s']:.1f} img/s) over {timed_steps} steps, device {device_ms:.2f} "
          f"ms/step, busy share {out['busy']:.3f} (under the profiler {profiled_wall:.2f} "
          f"ms/step, {out['busy_under_profiler']:.3f})  [{card}]")
    return out


def phase14(device, card, tmp, CC, C, reset_counts, read_counts):
    """Phase 14: the file datasets and the CUB recipe at 448 px; see the
    module's docstring.  Returns the numbers for the JSON line."""
    import torch

    from semantic_embeddings_torch.cli import common, evaluate_classification_accuracy
    from semantic_embeddings_torch.data import get_data_generator
    from semantic_embeddings_torch.models.resnet import use_plain_conv_bn_stats
    from semantic_embeddings_torch.ops import fused_cosine_loss
    from semantic_embeddings_torch.train import make_train_step, new_train_state

    out = {}
    t_phase = time.perf_counter()

    # -- 14a. the host's JPEG libraries and the decode plan -------------
    phase("14a probe the host's JPEG libraries, choose the decode plan")
    probe, plan, build_error = probe_host()
    for key, value in probe.items():
        print(f"probe {key}: {value}")
    if build_error:
        print("finding: the native decoder does not build on this host:\n"
              + "\n".join(build_error.splitlines()[:12]))
    check(plan != "C", "neither libjpeg nor Pillow on this host (plan C: an nvJPEG "
                       "decoder, which is not written)")
    decoder = "native" if plan == "A" else "pillow"
    print(f"decode plan {plan}: the file datasets decode with "
          f"{'the native decoder' if plan == 'A' else 'Pillow (use_native = False)'}")
    out.update(probe=probe, plan=plan, decoder=decoder,
               native_build_error=build_error and build_error.splitlines()[-12:])

    # -- 14b. a CUB-layout directory from the seed ----------------------
    phase(f"14b write a CUB layout: {CUB_CLASSES} classes x ({CUB_TRAIN} train + "
          f"{CUB_TEST} test), shorter sides 300-500 px")
    cub = os.path.join(tmp, "cub")
    t0 = time.perf_counter()
    n_files, nbytes = write_cub(cub)
    print(f"wrote {n_files} JPEGs ({nbytes / 2**20:.1f} MiB) in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 14c. the host decode rates -------------------------------------
    phase(f"14c host decode rates ({decoder}), CUB's test and train transforms")
    rates = decode_rates(cub, decoder, card)
    out["decode_img_per_s"] = rates
    if plan == "A" and probe["pillow"]:
        ds = get_data_generator("cub", cub)
        files = ds.test_img_files[:DECODE_IMAGES]
        native_batch = ds._compose(files, False, np.random.default_rng(0))
        ds.use_native = False
        pillow_batch = ds._compose(files, False, np.random.default_rng(0))
        diff = np.abs(native_batch.astype(np.int16) - pillow_batch).mean()
        print(f"native center crops vs Pillow's: mean |diff| {diff:.3f} (bound 12)")
        check(diff < 12, diff)
        out["native_vs_pillow_mean_abs_diff"] = float(diff)

    # -- 14d. the recipe, in its own process ----------------------------
    phase(f"14d learn_image_embeddings --dataset cub (resnet-50 @ 448, batch {CUB_BATCH}, "
          f"--bf16, {CUB_EPOCHS} epochs) in its own process; 14e beside it")
    feat_path, model_path = os.path.join(tmp, "cub_feat.pickle"), os.path.join(tmp, "cub.pt")
    argv = ["--dataset", "cub", "--data_root", cub, "--embedding", "onehot",
            "--loss", "inv_corr", "--fused_loss", "--architecture", CUB_ARCH,
            "--lr_schedule", "SGDR", "--sgdr_base_len", "12", "--sgdr_mul", "2",
            "--sgdr_max_lr", "0.05", "--batch_size", str(CUB_BATCH), "--bf16",
            "--epochs", str(CUB_EPOCHS), "--read_workers", str(READ_WORKERS),
            "--queue_size", "6", "--decoder", decoder, "--feature_dump", feat_path,
            "--model_dump", model_path, "--device", device.type]
    # the CLI's main in a process of its own, which prints its launches
    runner = (
        "import json, sys, torch\n"
        "from semantic_embeddings_torch.cli import learn_image_embeddings as m\n"
        "from semantic_embeddings_torch.ops import conv1x1 as c1, conv3x3 as CC, "
        "cosine_loss as C\n"
        "state = m.main(sys.argv[1:])\n"
        "if torch.cuda.is_available():\n"
        "    torch.cuda.synchronize()\n"
        "print('LAUNCHES ' + json.dumps({'steps': state.step,"
        " 'cosine_loss_fwd': C.launches_fwd, 'cosine_loss_bwd': C.launches_bwd,"
        " 'conv3x3_bn_stats': CC.launches_conv_bn_stats,"
        " 'conv3x3_filter_grad': CC.launches_filter_grad,"
        " 'conv1x1_filter_grad': c1.launches_filter_grad}))\n")
    sys.stdout.flush()
    t_recipe = time.perf_counter()
    recipe = subprocess.Popen([sys.executable, "-c", runner, *argv], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # -- 14e. one step on a file batch: kernels vs plain vs f64 ---------
    phase("14e one resnet-50 @ 448 step on a file-pipeline batch: kernel vs plain vs "
          "f64, f32 (TF32 off) and bf16")
    ds = get_data_generator("cub", cub)
    common.apply_pipeline_args(ds, argparse.Namespace(
        read_workers=READ_WORKERS, queue_size=6, decoder=decoder))
    embedding = np.eye(CUB_CLASSES, dtype=np.float32)
    prepare = ds.make_prepare(device)

    def cub_model(seed):
        model, spec = common.build_embedding_model(CUB_CLASSES, CUB_ARCH, "inv_corr", 0,
                                                   seed=seed)
        return new_train_state(model.to(device)), spec

    def cub_step(state, spec, prep, plain=False, autocast_dtype=None):
        """The CLI's --fused_loss step for --embedding onehot (no cls head)."""
        loss = ((lambda tgt, z: C.PlainCosineLoss.apply(z, tgt)) if plain
                else (lambda tgt, z: fused_cosine_loss(z, tgt)))
        return make_train_step(state.model.twin("linear"), prep, loss_name="inv_corr",
                               class_embedding=embedding, num_classes=CUB_CLASSES,
                               l2_penalty_fn=spec.l2_penalty, clipnorm=10.0,
                               loss_fn_override=loss, autocast_dtype=autocast_dtype)

    raw = next(iter(ds.train_batches(CUB_BATCH, 0, 0)))
    check(raw["image"].shape == (CUB_BATCH, 448, 448, 3) and raw["image"].is_pinned(),
          (raw["image"].shape, raw["image"].is_pinned()))

    def prepare_64(raw, rng, train):
        images, labels_ = prepare(raw, rng, train)
        return images.double(), labels_

    def one_step(state, spec, prep, plain=False, autocast_dtype=None):
        # the same augmentation draws for every run: a fresh generator
        rng = torch.Generator(device=device).manual_seed(7)
        _, metrics = cub_step(state, spec, prep, plain, autocast_dtype)(state, raw, 0.05, rng)
        torch.cuda.synchronize()
        return metrics["loss"].item()

    state_k, spec = cub_model(seed=3)
    before = copy.deepcopy(state_k.model.state_dict())
    state_p = copy.deepcopy(state_k)
    use_plain_conv_bn_stats(state_p.model)
    state_64 = new_train_state(copy.deepcopy(state_p.model).double())
    reset_counts()
    loss_k = one_step(state_k, spec, prepare)
    step_counts = read_counts()
    loss_p = one_step(state_p, spec, prepare, plain=True)
    loss_64 = one_step(state_64, spec, prepare_64, plain=True)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"f32 loss kernel {loss_k:.9f} plain {loss_p:.9f} f64 {loss_64:.9f}; kernel vs "
          f"plain {rel:.3g} relative; launches of the kernel step {step_counts}")
    check(rel <= 1e-5, rel)
    check(step_counts == {"cosine_loss_fwd": 1, "cosine_loss_bwd": 1,
                          "conv3x3_bn_stats": 16, "conv3x3_filter_grad": 16,
                          "conv1x1_filter_grad": RN50_1X1}, step_counts)
    f32_dist = check_against_f64(before, state_64.model, state_k.model, state_p.model,
                                 "f32 ")
    del state_p
    bf16_k, _ = cub_model(seed=3)
    bf16_p = copy.deepcopy(bf16_k)
    use_plain_conv_bn_stats(bf16_p.model)
    loss_k16 = one_step(bf16_k, spec, prepare, autocast_dtype=torch.bfloat16)
    loss_p16 = one_step(bf16_p, spec, prepare, plain=True, autocast_dtype=torch.bfloat16)
    rel16 = abs(loss_k16 - loss_p16) / abs(loss_p16)
    print(f"bf16 loss kernel {loss_k16:.9f} plain {loss_p16:.9f} (f64 {loss_64:.9f}); "
          f"kernel vs plain {rel16:.3g} relative")
    check(rel16 <= 1e-2, rel16)
    bf16_dist = check_against_f64(before, state_64.model, bf16_k.model, bf16_p.model, "bf16 ")
    out["step_vs_f64"] = {
        "f32": {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_f64": loss_64,
                "kernel_vs_plain_rel": rel, "distance": f32_dist},
        "bf16": {"loss_kernel": loss_k16, "loss_plain": loss_p16,
                 "kernel_vs_plain_rel": rel16, "distance": bf16_dist},
        "launches_per_step": step_counts}
    del state_64, bf16_k, bf16_p, before
    torch.cuda.empty_cache()

    # 14d's result
    stdout, stderr = recipe.communicate()
    recipe_s = time.perf_counter() - t_recipe
    print(f"14d learn_image_embeddings exit {recipe.returncode}, done {recipe_s:.1f} s after "
          f"its start\n{stdout.strip()}")
    if recipe.returncode:
        print(stderr[-4000:])
    check(recipe.returncode == 0, "the CUB recipe failed")
    n_losses = finite_losses("learn_image_embeddings --dataset cub", stdout)
    launches = json.loads(re.search(r"^LAUNCHES (.*)$", stdout, re.M).group(1))
    steps = CUB_EPOCHS * -(-CUB_CLASSES * CUB_TRAIN // CUB_BATCH)
    val = -(-CUB_CLASSES * CUB_TEST // CUB_BATCH)
    # fit validates each epoch; the final validation and the onehot
    # features' pass each run the test batches once more
    want = {"steps": steps, "cosine_loss_fwd": steps, "cosine_loss_bwd": steps,
            "conv3x3_bn_stats": RN50_CONVS * (steps + (CUB_EPOCHS + 2) * val),
            "conv3x3_filter_grad": RN50_CONVS * steps, "conv1x1_filter_grad": 0}
    check(launches == want, (launches, want))
    pipeline = f"file pipeline: {READ_WORKERS} read workers, a queue of 6 batches, " + (
        "native" if plan == "A" else "Pillow") + " decoder"
    check(pipeline in stdout, f"the CLI did not print {pipeline!r}")
    print(f"{n_losses} printed losses, all finite; launches {launches} (16 + 16 conv "
          f"kernels a step); {pipeline!r}")
    out["recipe"] = {"seconds": recipe_s, "launches": launches, "losses_printed": n_losses}

    # -- 14f. throughput at batch 24: device-only and composite ---------
    phase(f"14f resnet-50 @ 448 bf16 step at batch {CUB_BATCH}: device-only and fed by "
          "the file pipeline")
    step = cub_step(state_k, spec, prepare, autocast_dtype=torch.bfloat16)
    resident = [{"image": r["image"].to(device), "label": r["label"]}
                for _, r in zip(range(8), ds.train_batches(CUB_BATCH, 0, 0))]
    device_only = profile_step(state_k, step, resident,
                               f"cub device-only bf16, batch {CUB_BATCH} [{card}]",
                               n=4, batch=CUB_BATCH)
    composite = composite_rate(state_k, step, ds, device, card, epoch=1)
    per_core = rates["train"][1]
    cores = device_only["img_per_s"] / per_core
    print(f"device-only {device_only['img_per_s']:.1f} img/s, composite "
          f"{composite['img_per_s']:.1f} img/s ({composite['img_per_s'] / device_only['img_per_s']:.3f} "
          f"of it); host cores the step needs: device img/s / decode img/s per core = "
          f"{device_only['img_per_s']:.1f} / {per_core:.1f} = {cores:.2f} "
          f"(this host: {probe['affinity']})  [{card}]")
    out["throughput"] = {"device_only": device_only, "composite": composite,
                         "decode_img_per_s_per_core": per_core, "host_cores_needed": cores}
    del state_k, step, resident
    torch.cuda.empty_cache()

    # -- 14g + 14h: stage 3 on 14d's dumps, two more recipes ------------
    phase("14g stage 3 on 14d's dumps; 14h learn_classifier --dataset cub and "
          "learn_image_embeddings --dataset nab-large (own processes, at once)")
    taxonomy = os.path.join(tmp, "cub_taxonomy.parent-child.txt")
    write_taxonomy_cub(taxonomy)
    # the class ids the taxonomy names, in the dataset's label order (what
    # an embedding's ind2label gives; the recipe's targets are onehot)
    classes_from = os.path.join(tmp, "cub_classes.pickle")
    with open(classes_from, "wb") as f:
        pickle.dump({"ind2label": list(range(1, CUB_CLASSES + 1))}, f)
    sub_cub, sub_nab = os.path.join(tmp, "cub_sub"), os.path.join(tmp, "nab_sub")
    write_subset(cub, sub_cub, SUB_CLASSES)
    write_subset(cub, sub_nab, SUB_CLASSES)
    cls_dump = os.path.join(tmp, "cub_classifier.pt")
    common_flags = ["--batch_size", str(CUB_BATCH), "--bf16", "--read_workers", "4",
                    "--queue_size", "4", "--decoder", decoder, "--device", device.type]
    outs = run_clis({
        "retrieval": ("evaluate_retrieval", [
            "--dataset", "cub", "--data_root", cub, "--hierarchy", taxonomy,
            "--classes_from", classes_from, "--feat", feat_path, "--device", device.type]),
        # the default --decoder auto: the native decoder where it builds, else Pillow
        "classification": ("evaluate_classification_accuracy", [
            "--dataset", "cub", "--data_root", cub, "--hierarchy", taxonomy,
            "--classes_from", classes_from, "--model", model_path, "--layer", "l2norm", "--prob_features", "1",
            "--batch_size", str(CUB_BATCH), "--device", device.type]),
        "classifier": ("learn_classifier", [
            "--dataset", "cub", "--data_root", sub_cub, "--architecture", CUB_ARCH,
            "--label_smoothing", "0.1", "--lr_schedule", "SGDR", "--sgdr_max_lr", "0.05",
            "--epochs", "1", "--model_dump", cls_dump, *common_flags]),
        "nab_large": ("learn_image_embeddings", [
            "--dataset", "nab-large", "--data_root", sub_nab, "--embedding", "onehot",
            "--loss", "inv_corr", "--cls_weight", "0.1", "--fused_loss",
            "--architecture", CUB_ARCH, "--lr_schedule", "SGDR", "--sgdr_base_len",
            "60", "--sgdr_mul", "3", "--sgdr_max_lr", "0.5", "--epochs", "1",
            "--max_decay", "0.1", *common_flags]),
    })
    chosen = f"{'native' if plan == 'A' else 'Pillow'} decoder (--decoder auto)"
    check(chosen in outs["classification"], f"--decoder auto did not choose: {chosen}")
    check(plan == "A" or "native decoder unavailable (" in outs["classification"],
          "--decoder auto fell back without the JAX package's message")
    print(f"evaluate_classification_accuracy with the default --decoder auto: {chosen}")
    out["decoder_auto"] = chosen
    retrieval = parse_table(outs["retrieval"])
    accuracy = parse_table(outs["classification"])
    for table in (retrieval, accuracy):
        for row in table.values():
            check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in row.values()), row)
    for name in ("classifier", "nab_large"):
        finite_losses(name, outs[name])
        check("epoch 1/1" in outs[name], f"{name} ran no epoch")
    print(f"retrieval {retrieval}; classification {accuracy}")
    out["stage3"] = {"retrieval": retrieval, "classification": accuracy}
    table = run_cli("evaluate_classification_accuracy", "--dataset", "cub", "--data_root",
                    sub_cub, "--model", cls_dump, "--layer", "prob", "--prob_features", "1",
                    "--batch_size", str(CUB_BATCH), "--decoder", decoder, "--device", device.type)
    out["classifier_accuracy"] = parse_table(table)
    # the augmented feature pass of the SVM mode (which needs scikit-learn):
    # two passes over the training files with the host's train transforms
    model, _ = common.rebuild_model_from_checkpoint(model_path, device)
    aug_ds = get_data_generator("cub", cub)
    common.apply_pipeline_args(aug_ds, argparse.Namespace(
        read_workers=READ_WORKERS, queue_size=6, decoder=decoder))
    x_train, y_train = evaluate_classification_accuracy.train_features(
        aug_ds, model, device, "l2norm", augmentation_epochs=2, batch_size=CUB_BATCH)
    n_train = CUB_CLASSES * CUB_TRAIN
    check(x_train.shape == (2 * n_train, CUB_CLASSES) and np.isfinite(x_train).all()
          and len(y_train) == 2 * n_train, (x_train.shape, len(y_train)))
    moved = float(np.abs(x_train[:n_train] - x_train[n_train:]).max())
    check(moved > 0, "the two augmented passes gave the same features")
    print(f"augmented training features {x_train.shape} over 2 passes; the passes differ "
          f"by up to {moved:.3g}")
    out["augmented_features"] = {"shape": list(x_train.shape), "max_pass_diff": moved}
    del model
    torch.cuda.empty_cache()

    # -- 14i. serving 14d's model, JPEG bodies --------------------------
    phase(f"14i serve 14d's model (--decode_threads 4, {decoder} decoder): a JPEG body "
          "against the npy body of its decoded pixels")
    from semantic_embeddings_torch.cli import serve_model
    from semantic_embeddings_torch.serving import ServingClient

    args = serve_model.build_parser().parse_args([
        "--checkpoint", model_path, "--layer", "l2norm", "--input_size", "448",
        "--target_size", "512", "--dataset", "cub", "--decode_threads", "4",
        "--decoder", decoder, "--port", "0", "--max_batch", "4", "--device", device.type])
    srv = serve_model.make_server(args).start()
    try:
        client = ServingClient(f"http://127.0.0.1:{srv.port}")
        same = []
        for path in ds.test_img_files[:4]:
            with open(path, "rb") as f:
                blob = f.read()
            pixels = srv.preproc.decode_jpeg(blob)
            got = client.predict_jpeg(blob)
            want = client.predict(pixels[None], wire_dtype=np.uint8)
            check(got.shape == (1, CUB_CLASSES) and np.isfinite(got).all(), got.shape)
            same.append(bool(np.array_equal(got, want)))
    finally:
        srv.stop()
    check(all(same), same)
    print(f"{len(same)} JPEG bodies: answers bitwise equal to the npy bodies of the "
          f"pixels the server's {decoder} decoder gives")
    out["serving_jpeg_bitwise"] = same
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14 took {out['seconds']:.1f} s")
    return out


# phase 15: checkpoint interop and the host-side CLIs.  15c's --finetune:
# ResNet-50 @ 224, batch 32, 3 steps a phase, one validation batch, a
# 50-d embedding (the source's top is 100-d, so it is skipped)
FT_BATCH, FT_STEPS, FT_VAL, FT_EMBED = 32, 3, 1, 50


def same_forward(model_a, model_b, images, reset_counts, read_counts):
    """Eval forwards of two models on ``images``: whether every output is
    bitwise equal, and the kernel launches of ``model_b``'s forward."""
    import torch

    with torch.inference_mode():
        out_a = model_a(images)
        reset_counts()
        out_b = model_b(images)
        torch.cuda.synchronize()
        counts = read_counts()
    out_a = out_a if isinstance(out_a, tuple) else (out_a,)
    out_b = out_b if isinstance(out_b, tuple) else (out_b,)
    return all(torch.equal(a, b) for a, b in zip(out_a, out_b)), counts


def same_weights(model_a, model_b):
    """The names of the ``state_dict`` entries that differ (none: bitwise)."""
    import torch

    b = model_b.state_dict()
    return [k for k, v in model_a.state_dict().items()
            if k not in b or not torch.equal(v.cpu(), b[k].cpu())]


def phase15(device, card, tmp, hierarchy, feat_path, slice1_dump, rn50_ckpt,
            reset_counts, read_counts):
    """Phase 15: checkpoint interop (the JAX package's model and weight
    dumps, Keras h5 export and import) and the host-side CLIs, at full
    width; see the module's docstring.  Returns the numbers for the JSON
    line."""
    import torch

    from semantic_embeddings_torch.cli import (
        common, compute_class_embedding, encode_hierarchy, export_keras_weights,
        import_keras_weights, learn_image_embeddings, plot_recall_precision)
    from semantic_embeddings_torch.embeddings import load_embeddings, save_embeddings
    from semantic_embeddings_torch.hierarchy import ClassHierarchy, semantic_distance_matrix
    from semantic_embeddings_torch.train import state as tstate

    out = {}
    t_phase = time.perf_counter()

    # -- 15a. what the card's host has ------------------------------------
    phase("15a probe: h5py, matplotlib, tensorboard on this host")
    probe = {}
    for name in ("h5py", "matplotlib", "tensorboard"):
        try:
            probe[name] = __import__(name).__version__
        except ImportError:
            probe[name] = None
        print(f"probe {name}: {probe[name] or 'not importable'}")
    out["probe"] = probe

    # -- 15b. a JAX model dump of phase 8's ResNet-50 ---------------------
    phase("15b phase 8's resnet-50 as a JAX package model dump: read, rebuilt, "
          "evaluate_classification_accuracy")
    source, meta = common.rebuild_model_from_checkpoint(rn50_ckpt, device)
    state = tstate.new_train_state(source)
    tstate.load_checkpoint(rn50_ckpt, state)  # the velocity and counters too
    jax_dump = os.path.join(tmp, "resnet50_jax.ckpt")
    t0 = time.perf_counter()
    tstate.save_jax_checkpoint(jax_dump, state, meta)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(jax_dump) / 1e6
    t0 = time.perf_counter()
    tree, jax_meta = tstate.read_jax_checkpoint(jax_dump)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rebuilt, _ = common.rebuild_model_from_checkpoint(jax_dump, device)
    rebuild_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in rebuilt.parameters())
    print(f"JAX model dump of {n_params:,} parameters: {mb:.1f} MB written in {write_s:.3f} s; "
          f"read (pickle + msgpack) in {read_s:.4f} s, {mb / read_s:.0f} MB/s; rebuilt on the "
          f"card in {rebuild_s:.2f} s")
    check(jax_meta == meta, (jax_meta, meta))
    check(tstate.checkpoint_format(jax_dump) == "jax_checkpoint", "format")
    check(not same_weights(source, rebuilt), same_weights(source, rebuilt))
    images = torch.randn(64, SERVE_SIZE, SERVE_SIZE, 3,
                         generator=torch.Generator().manual_seed(15)).to(device)
    equal, counts = same_forward(source, rebuilt, images, reset_counts, read_counts)
    check(equal and counts["conv3x3_bn_stats"] == RN50_CONVS
          and counts["conv1x1_filter_grad"] == 0, (equal, counts))
    print(f"eval forward of the rebuilt JAX dump at batch 64: bitwise equal to the source "
          f"checkpoint's; launches {counts}")
    del tree, state, rebuilt
    name = f"synthetic-100-{RN50_TRAIN}-{RN50_TEST}-{SERVE_SIZE}"
    argv = ["--dataset", name, "--data_root", tmp, "--layer", "prob", "--prob_features", "1",
            "--batch_size", str(RN50_BATCH), "--device", device.type]
    outs = run_clis({
        "jax_dump": ("evaluate_classification_accuracy", argv + ["--model", jax_dump]),
        "port_checkpoint": ("evaluate_classification_accuracy", argv + ["--model", rn50_ckpt])})
    tables = {k: list(parse_table(v).values()) for k, v in outs.items()}  # rows: file stems
    check(tables["jax_dump"] == tables["port_checkpoint"], tables)
    out["jax_checkpoint"] = {
        "mb": mb, "write_s": write_s, "read_s": read_s, "read_mb_per_s": mb / read_s,
        "rebuild_s": rebuild_s, "launches": counts, "forward_bitwise": equal,
        "evaluate_classification_accuracy": tables["jax_dump"][0]}

    # -- 15c. --finetune from a JAX weight dump ---------------------------
    phase(f"15c learn_image_embeddings --finetune <JAX weight dump>: resnet-50 @ 224, "
          f"batch {FT_BATCH}, --finetune_init 1, {FT_STEPS} steps a phase")
    weights = os.path.join(tmp, "resnet50_jax.msgpack")
    tstate.save_jax_weights(weights, source)
    check(tstate.checkpoint_format(weights) == "jax_weights", "format")
    emb50 = os.path.join(tmp, "embedding50.pickle")
    e = np.random.default_rng(15).normal(size=(100, FT_EMBED))
    save_embeddings(emb50, list(range(100)), e / np.linalg.norm(e, axis=1, keepdims=True))
    from semantic_embeddings_torch import train as T

    record, load, finetune = {}, T.load_weights_by_name, common.finetune

    def load_checked(path, model):
        before = {n: b.clone() for n, b in model.named_buffers()}
        loaded, skipped = load(path, model)
        record.update(loaded=loaded, skipped=skipped, statistics_kept=all(
            torch.equal(b, before[n]) for n, b in model.named_buffers()))
        return loaded, skipped

    def finetune_counted(args, state, warm_step, eval_step, dataset):
        reset_counts()
        t0 = time.perf_counter()
        state = finetune(args, state, warm_step, eval_step, dataset)
        torch.cuda.synchronize()
        record["phase1_s"] = time.perf_counter() - t0
        record["phase1"] = read_counts()
        reset_counts()
        record["t_phase2"] = time.perf_counter()
        return state

    T.load_weights_by_name, common.finetune = load_checked, finetune_counted
    log_dir = os.path.join(tmp, "finetune_logs")
    tee = _Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            state = learn_image_embeddings.main([
                "--dataset", f"synthetic-100-{FT_STEPS * FT_BATCH}-{FT_VAL * FT_BATCH}-{SERVE_SIZE}",
                "--data_root", tmp, "--embedding", emb50, "--architecture", "resnet-50",
                "--loss", "inv_corr", "--cls_weight", "0.1", "--fused_loss",
                "--lr_schedule", "SGDR", "--sgdr_max_lr", "0.05", "--batch_size",
                str(FT_BATCH), "--epochs", "1", "--finetune", weights, "--finetune_init", "1",
                "--log_dir", log_dir, "--device", device.type])
    finally:
        T.load_weights_by_name, common.finetune = load, finetune
    torch.cuda.synchronize()
    phase2_s = time.perf_counter() - record["t_phase2"]
    phase2 = read_counts()
    finite_losses("learn_image_embeddings --finetune <JAX weight dump>", tee.buf.getvalue())
    sd = state.model.state_dict()
    params = {n for n, _ in state.model.named_parameters()}
    backbone = sorted(n for n in params
                      if n.startswith("backbone.") and not n.startswith("backbone.top."))
    # every backbone parameter but the 50-d top; of the heads only the
    # 100-way cls_top's bias has the source's shape (the JAX rule: path and shape)
    want_loaded = sorted(backbone + ["cls_top.bias"])
    printed = re.search(r"Loaded (\d+) of (\d+) tensors by name", tee.buf.getvalue())
    check(printed and int(printed.group(1)) == len(want_loaded)
          and int(printed.group(2)) == len(sd), (printed and printed.groups(), len(backbone)))
    check(sorted(record["loaded"]) == want_loaded,
          sorted(set(want_loaded) ^ set(record["loaded"])))
    check(record["statistics_kept"], "the JAX weight dump moved BN running statistics")
    check({"backbone/top/kernel", "backbone/top/bias", "cls_top/kernel"}
          <= set(record["skipped"]), record["skipped"][:8])
    want1 = {"cosine_loss_fwd": FT_STEPS, "cosine_loss_bwd": FT_STEPS,
             "conv3x3_bn_stats": RN50_CONVS * (FT_STEPS + FT_VAL), "conv3x3_filter_grad": 0,
             "conv1x1_filter_grad": 0}
    want2 = {"cosine_loss_fwd": FT_STEPS, "cosine_loss_bwd": FT_STEPS,
             "conv3x3_bn_stats": RN50_CONVS * (FT_STEPS + 2 * FT_VAL),
             "conv3x3_filter_grad": RN50_CONVS * FT_STEPS,
             "conv1x1_filter_grad": RN50_1X1 * FT_STEPS}
    check(record["phase1"] == want1 and phase2 == want2, (record["phase1"], phase2))
    print(f"--finetune from the JAX weight dump: loaded {len(backbone)} backbone parameters "
          f"of {len(sd)} entries, BN running statistics kept their initial values, skipped "
          f"{[k for k in record['skipped'] if '/' in k]}; phase 1 {record['phase1_s']:.2f} s, "
          f"launches {record['phase1']}; phase 2 {phase2_s:.2f} s, launches {phase2} "
          f"({FT_STEPS} steps + validation a phase, f32, batch {FT_BATCH}) [{card}]")
    # --log_dir: metrics.jsonl, and TensorBoard events where tensorboard imports
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    events = [n for n in os.listdir(log_dir) if n.startswith("events.out.tfevents")]
    check(len(logged) == 1 and math.isfinite(logged[0]["loss"]), logged)
    check(bool(events) == (probe["tensorboard"] is not None), events)
    print(f"--log_dir: {len(logged)} epoch in metrics.jsonl, TensorBoard event files {events}")
    out["finetune_jax"] = {"loaded": len(backbone), "entries": len(sd),
                           "skipped": record["skipped"], "phase1": record["phase1"],
                           "phase2": phase2, "phase1_s": record["phase1_s"],
                           "phase2_s": phase2_s}
    del state
    torch.cuda.empty_cache()

    # -- 15d. Keras h5: export, then import -------------------------------
    have_h5 = probe["h5py"] is not None
    phase("15d export_keras_weights -> import_keras_weights: resnet-50 (phase 8) and "
          "resnet-110-wfc (phase 5), " + ("through h5 files and both CLIs" if have_h5 else
                                          "h5py missing: export_layers -> map_layers"))
    out["keras"] = {"through_h5": have_h5}
    for arch, ckpt in (("resnet-50", rn50_ckpt), ("resnet-110-wfc", slice1_dump)):
        model, meta = common.rebuild_model_from_checkpoint(ckpt, device)
        cls_classes = meta.get("cls_classes", 0)
        t0 = time.perf_counter()
        if have_h5:
            h5 = os.path.join(tmp, f"{arch}.h5")
            export_keras_weights.main(["--model", ckpt, "--out", h5])
            export_s = time.perf_counter() - t0
            imported_path = os.path.join(tmp, f"{arch}_imported.pt")
            t0 = time.perf_counter()
            import_keras_weights.main([
                "--h5", h5, "--architecture", arch, "--embed_dim", str(meta["embed_dim"]),
                "--cls_classes", str(cls_classes), "--out", imported_path,
                "--device", device.type])
            imported, _ = common.rebuild_model_from_checkpoint(imported_path, device)
        else:
            from semantic_embeddings_torch import convert

            layers = export_keras_weights.export_layers(
                convert.state_dict_to_flax(model), arch, cls_classes)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            imported, _, skipped = import_keras_weights.import_layers(
                {name: arrays for name, _, arrays in layers}, arch, meta["embed_dim"],
                cls_classes=cls_classes, device=device)
            check(not skipped, skipped)
            imported.eval()
        import_s = time.perf_counter() - t0
        differ = same_weights(model, imported)
        size = SERVE_SIZE if arch == "resnet-50" else 32
        images = torch.randn(32, size, size, 3,
                             generator=torch.Generator().manual_seed(16)).to(device)
        equal, counts = same_forward(model, imported, images, reset_counts, read_counts)
        check(not differ and equal and counts["conv1x1_filter_grad"] == 0,
              (arch, differ[:5], equal, counts))
        if arch == "resnet-50":
            check(counts["conv3x3_bn_stats"] == RN50_CONVS, counts)
        print(f"{arch}: exported in {export_s:.2f} s, imported in {import_s:.2f} s; every "
              f"tensor and the eval forward at batch 32 bitwise equal to the source; "
              f"launches {counts} [{card}]")
        out["keras"][arch] = {"export_s": export_s, "import_s": import_s, "launches": counts,
                              "weights_bitwise": not differ, "forward_bitwise": equal}
        del model, imported
    torch.cuda.empty_cache()

    # -- 15e. compute_class_embedding --device ------------------------------
    phase("15e compute_class_embedding --device (float64 on the card) vs the host")
    labels = list(range(100))
    target = 1.0 - semantic_distance_matrix(ClassHierarchy.from_file(hierarchy, id_type=int),
                                            labels)
    out["class_embedding"] = {}
    for method in ("unitsphere", "approx_sim"):
        products = {}
        # the card is the default, and a bare --device (the JAX package's flag)
        # means it too; --device cpu runs host LAPACK
        for where, extra in (("card", ["--device"]), ("host", ["--device", "cpu"])):
            path = os.path.join(tmp, f"emb_{method}_{where}.pickle")
            t0 = time.perf_counter()
            compute_class_embedding.main(["--hierarchy", hierarchy, "--out", path,
                                          "--method", method, *extra])
            seconds = time.perf_counter() - t0
            got_labels, emb = load_embeddings(path)
            check(got_labels == labels, "labels")
            products[where] = (emb @ emb.T, seconds)
        err = float(np.abs(products["card"][0] - target).max())
        err_host = float(np.abs(products["card"][0] - products["host"][0]).max())
        check(err <= 1e-10 and err_host <= 1e-10, (method, err, err_host))
        print(f"{method} --device: max |E E^T - S| {err:.3g}, vs the host's E E^T "
              f"{err_host:.3g}; card {products['card'][1]:.2f} s, host "
              f"{products['host'][1]:.2f} s (the CLI, 100 classes)")
        out["class_embedding"][method] = {"vs_target": err, "vs_host": err_host}

    # -- 15f. plot_recall_precision, encode_hierarchy -------------------------
    phase("15f plot_recall_precision on phase 5's feature dump (ranking on the card); "
          "encode_hierarchy")
    if probe["matplotlib"] is not None:
        png = os.path.join(tmp, "recall_precision.png")
        t0 = time.perf_counter()
        curves = plot_recall_precision.main([
            "--dataset", DATASET, "--data_root", tmp, "--feat", feat_path, "--bins", "20",
            "--out", png, "--device", device.type])
        (levels, precisions, mean_ap), = curves.values()
        check(0.0 <= mean_ap <= 1.0 and 1 <= len(levels) <= 21 and os.path.getsize(png) > 0,
              (mean_ap, len(levels)))
        print(f"plot_recall_precision: mAP {mean_ap:.6f} over {len(levels)} recall levels in "
              f"{time.perf_counter() - t0:.2f} s")
        out["plot_recall_precision_map"] = mean_ap
    else:
        print("matplotlib is not importable on this host: plot_recall_precision not run "
              "(the CPU tests hold it to the JAX CLI)")
    tree = os.path.join(tmp, "taxonomy_tree.txt")
    rng = np.random.default_rng(17)
    lines = ["root"]
    for g in range(20):
        lines.append(f"-- group{g}")
        lines += [f"---- leaf{g}_{c}" for c in range(int(rng.integers(2, 7)))]
    with open(tree, "w") as f:
        f.write("\n".join(lines) + "\n")
    edges = os.path.join(tmp, "taxonomy_tree.parent-child.txt")
    encode_hierarchy.main([tree, "--out", edges, "--one_based"])
    encoded = ClassHierarchy.from_file(edges, id_type=int)
    check(len(encoded.leaves()) == len(lines) - 21 and len(encoded.nodes) == len(lines),
          (len(encoded.leaves()), len(encoded.nodes)))
    out["encode_hierarchy_nodes"] = len(encoded.nodes)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15 took {out['seconds']:.1f} s")
    return out


def rn50_state(device, seed=0):
    """ResNet-50 embedding 100 dims + l2norm output + the 100-way cls head,
    random weights from ``seed``, on ``device``; and its spec."""
    import torch

    from semantic_embeddings_torch.models import EmbeddingModel, build_network
    from semantic_embeddings_torch.train import new_train_state

    g = torch.Generator().manual_seed(seed)
    spec = build_network(100, "resnet-50", generator=g)
    # the CLI's rule for the cls head, before the (empty) backbone list
    spec.l2_filters = [(r"^cls_top$", 5e-4)] + list(spec.l2_filters)
    model = EmbeddingModel(spec.module, output="l2norm", cls_classes=100, generator=g)
    return new_train_state(model.to(device)), spec


def rn50_train_step(state, spec, prepare, embedding, plain=False, autocast_dtype=None):
    """The CLI's --fused_loss train step (inv_corr + 0.1 cls head, clipnorm
    10), through the kernels or through the plain versions."""
    from semantic_embeddings_torch.ops import cosine_loss as C
    from semantic_embeddings_torch.ops import fused_cosine_loss
    from semantic_embeddings_torch.train import make_train_step

    model = state.model.twin("linear", cls_input="l2norm")
    loss = ((lambda tgt, z: C.PlainCosineLoss.apply(z, tgt)) if plain
            else (lambda tgt, z: fused_cosine_loss(z, tgt)))
    return make_train_step(
        model, prepare, loss_name="inv_corr", class_embedding=embedding,
        num_classes=100, cls_weight=0.1, l2_penalty_fn=spec.l2_penalty,
        clipnorm=10.0, loss_fn_override=loss, autocast_dtype=autocast_dtype)


def reset_launches():
    from semantic_embeddings_torch.ops import conv1x1 as c1
    from semantic_embeddings_torch.ops import conv3x3 as CC
    from semantic_embeddings_torch.ops import cosine_loss as C

    C.launches_fwd = C.launches_bwd = 0
    CC.launches_conv_bn_stats = CC.launches_filter_grad = 0
    c1.launches_filter_grad = 0


def read_launches():
    from semantic_embeddings_torch.ops import conv1x1 as c1
    from semantic_embeddings_torch.ops import conv3x3 as CC
    from semantic_embeddings_torch.ops import cosine_loss as C

    return {"cosine_loss_fwd": C.launches_fwd, "cosine_loss_bwd": C.launches_bwd,
            "conv3x3_bn_stats": CC.launches_conv_bn_stats,
            "conv3x3_filter_grad": CC.launches_filter_grad,
            "conv1x1_filter_grad": c1.launches_filter_grad}


# phase 16: data parallelism on the one card.  16a: phase 8's recipe for 3
# steps through fit (then one validation batch), ResNet-50 @ 224, batch 128
P16_STEPS = 3
# 16d: learn_image_embeddings --gpus 2 on a 2-step ResNet-50 recipe
P16_CLI_TRAIN = 2 * RN50_BATCH


def p16_fit(device, data, embedding, seed):
    """Phase 8's --fused_loss recipe from the weights of ``seed`` through
    ``fit`` for one epoch of ``data``; the state dict on the host, the
    launches and the seconds."""
    import torch

    from semantic_embeddings_torch.train import fit, get_lr_schedule, make_eval_step

    state, spec = rn50_state(device, seed)
    prepare = data.make_prepare(device)
    eval_step = make_eval_step(state.model, prepare, loss_name="inv_corr",
                               class_embedding=embedding, num_classes=100, cls_weight=0.1,
                               l2_penalty_fn=spec.l2_penalty)
    schedule, _ = get_lr_schedule("SGD", data.num_train, RN50_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    state = fit(state, rn50_train_step(state, spec, prepare, embedding), eval_step, data,
                schedule, epochs=1, batch_size=RN50_BATCH, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ({k: v.cpu() for k, v in state.model.state_dict().items()}, read_launches(),
            seconds)


def p16a_worker(job_path, out_path):
    """16a, in a process of its own under a launcher's environment of world
    size 1: the 3 steps through ``fit`` without a group (the first run pays
    the process's first calls), in the NCCL group of one rank that
    ``initialize_distributed`` joins, and without a group again, each from
    the same weights; deterministic cuDNN, so that they may be held
    bitwise."""
    import torch

    from semantic_embeddings_torch import parallel
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.data import SyntheticDataset

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    common.set_float32_precision()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    device = torch.device("cuda", 0)
    data = SyntheticDataset(num_classes=100, n_train=P16_STEPS * RN50_BATCH,
                            n_test=RN50_BATCH, size=224, classes=job["labels"])
    first = p16_fit(device, data, job["embedding"], seed=2)
    check(parallel.initialize_distributed(device), "no group joined")
    backend, world = torch.distributed.get_backend(), parallel.world_size()
    grouped = p16_fit(device, data, job["embedding"], seed=2)
    parallel.finalize_distributed()
    alone = p16_fit(device, data, job["embedding"], seed=2)
    unequal = [k for k in alone[0] if not (torch.equal(alone[0][k], grouped[0][k])
                                          and torch.equal(first[0][k], grouped[0][k]))]
    with open(out_path, "w") as f:
        json.dump({"backend": backend, "world": world, "unequal": unequal,
                   "tensors": len(alone[0]),
                   "launches": {"alone": alone[1], "group": grouped[1]},
                   "seconds": {"alone_first": first[2], "group": grouped[2],
                               "alone": alone[2]}}, f)


def p16bc_worker(job_path, out_dir):
    """16b-16c, one of two ranks on the one card, joined by gloo (NCCL takes
    one rank a card; gloo moves CUDA tensors for ``all_reduce`` and
    ``broadcast``, all the training path uses): phase 9's step on this
    rank's 64 rows of its batch of 128, with sync BN, then with per-replica
    BN; rank 0 saves each state dict.  The launches of each rank, and
    whether both ranks hold the same tensors after each step."""
    import torch

    from semantic_embeddings_torch import parallel
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.models import layers

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    parallel.initialize_distributed(device, backend="gloo")
    common.set_float32_precision()
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    p9 = torch.load(job["phase9"], map_location="cpu", weights_only=True)
    world, rank = parallel.world_size(), parallel.rank()
    local = parallel.shard_batch({"x": p9["images"], "y": p9["labels"]})

    def prepare(raw, rng, train):
        return raw["x"].to(device), raw["y"].to(device)

    out = {"world": world, "backend": torch.distributed.get_backend()}
    # a first step, not kept, takes the process's first calls (cuDNN, the
    # kernels' load, the allocator, gloo's first transfers)
    for mode, groups in (("warm-up", 1), ("sync", 1), ("per_replica", 2)):
        layers.set_default_bn_groups(groups)
        state, spec = rn50_state(device, 1)
        state.model.load_state_dict(p9["before"])
        reset_launches()
        t0 = time.perf_counter()
        state, m = rn50_train_step(state, spec, prepare, job["embedding"])(
            state, local, 0.1, None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        sd = state.model.state_dict()
        flat = torch.cat([v.reshape(-1).float() for v in sd.values()])
        spread = parallel.sum_over_group(
            (flat - parallel.sum_over_group(flat) / world).abs().max()).item()
        counts = torch.tensor(list(launches.values()), dtype=torch.float64)
        out[mode] = {"launches": launches, "ranks_equal": spread == 0.0,
                     "launches_equal": bool((parallel.sum_over_group(counts)
                                             == world * counts).all()),
                     "loss": parallel.sum_over_group(m["loss"]).item() / world,
                     "seconds": seconds}
        if rank == 0 and mode != "warm-up":
            torch.save({k: v.cpu() for k, v in sd.items()}, os.path.join(out_dir, f"p16_{mode}.pt"))
    layers.set_default_bn_groups(1)
    if rank == 0:
        with open(os.path.join(out_dir, "p16bc.json"), "w") as f:
            json.dump(out, f)
    parallel.finalize_distributed()


def distances_from_f64(before, sd_64, sd):
    """Per tensor, the distance of ``sd`` from the f64 step ``sd_64``: in
    units of the tensor's f64 update for parameters, absolute for the BN
    running statistics (as :func:`check_against_f64` takes it)."""
    out = {}
    for n, old in before.items():
        ref = sd_64[n].double()
        stat = "running_" in n
        scale = 1.0 if stat else max((ref - old.double()).abs().max().item(), 1e-30)
        out[n] = (sd[n].double() - ref).abs().max().item() / scale
    return out


def hold_to_f64(label, before, sd_64, sd_ref, sd_new):
    """No tensor of ``sd_new`` farther from the f64 step than twice
    ``sd_ref``'s farthest (parameters and statistics apart); the running
    statistics of the two within 1e-5 relative.  Returns the worst
    distances and the statistics' worst relative gap."""
    ref = distances_from_f64(before, sd_64, sd_ref)
    new = distances_from_f64(before, sd_64, sd_new)
    out = {}
    for what, keep in (("parameter", lambda n: "running_" not in n),
                       ("BN statistic", lambda n: "running_" in n)):
        names = [n for n in before if keep(n)]
        worst_ref, worst_new = max(ref[n] for n in names), max(new[n] for n in names)
        far = sorted(names, key=lambda n: -new[n])[:3]
        print(f"{label} {what} distance from f64: worst {worst_new:.3g} (one process "
              f"{worst_ref:.3g}); farthest " + ", ".join(f"{n} {new[n]:.3g}" for n in far))
        bad = [n for n in names if new[n] > 2 * worst_ref + 1e-7]
        check(not bad, [(n, new[n], worst_ref) for n in bad[:10]])
        out[what] = {"worst": worst_new, "worst_one_process": worst_ref}
    gap = max((sd_new[n] - sd_ref[n]).abs().max().item()
              / max(sd_ref[n].abs().max().item(), 1e-30) for n in before if "running_" in n)
    print(f"{label} running statistics against the one-process step: {gap:.3g} relative")
    check(gap <= 1e-5, (label, gap))
    out["statistics_relative_gap"] = gap
    return out


def p16_cli(tmp, emb_path, card):
    """16d: ``learn_image_embeddings --gpus 2`` in two processes of its own on
    the one card at once: without a launcher (the JAX package's message;
    one process trains) and under a launcher's environment of world size 1
    (the NCCL group of one rank).  Each prints its launches."""
    import torch

    from semantic_embeddings_torch import parallel

    argv = ["--dataset", f"synthetic-100-{P16_CLI_TRAIN}-{RN50_BATCH}-224", "--data_root", tmp,
            "--embedding", emb_path, "--loss", "inv_corr", "--cls_weight", "0.1",
            "--fused_loss", "--architecture", "resnet-50", "--batch_size", str(RN50_BATCH),
            "--epochs", "1", "--lr_schedule", "SGD", "--sgd_lr", "0.01", "--gpus", "2",
            "--device", "cuda"]
    runner = (
        "import json, sys, torch\n"
        "from semantic_embeddings_torch.cli import learn_image_embeddings as m\n"
        "from semantic_embeddings_torch.ops import conv1x1 as c1, conv3x3 as CC, "
        "cosine_loss as C\n"
        "state = m.main(sys.argv[1:])\n"
        "torch.cuda.synchronize()\n"
        "print('LAUNCHES ' + json.dumps({'steps': state.step,"
        " 'cosine_loss_fwd': C.launches_fwd, 'cosine_loss_bwd': C.launches_bwd,"
        " 'conv3x3_bn_stats': CC.launches_conv_bn_stats,"
        " 'conv3x3_filter_grad': CC.launches_filter_grad,"
        " 'conv1x1_filter_grad': c1.launches_filter_grad}))\n")
    env_launch = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="localhost", MASTER_PORT=str(parallel.mesh.free_port()))
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-c", runner, *argv], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, env in (("no_launcher", None), ("launcher_world_1", env_launch))}
    out = {}
    steps = P16_CLI_TRAIN // RN50_BATCH
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        print(f"16d {name}: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s")
        print("\n".join(line for line in stdout.splitlines() if not line.startswith("LAUNCHES")))
        if proc.returncode:
            print(stderr[-4000:])
        check(proc.returncode == 0, f"16d {name} failed")
        check("Requested 2 devices but only 1 present; using 1." in stdout, f"16d {name}: message")
        launches = json.loads(stdout.split("LAUNCHES ", 1)[1].splitlines()[0])
        print(f"16d {name} launches {launches}")
        check(launches["steps"] == steps and launches["cosine_loss_fwd"] == steps
              and launches["cosine_loss_bwd"] == steps
              and launches["conv3x3_filter_grad"] == RN50_CONVS * steps
              and launches["conv1x1_filter_grad"] == RN50_1X1 * steps
              and launches["conv3x3_bn_stats"] > RN50_CONVS * steps, launches)
        out[name] = {"launches": launches, "nccl": "(nccl)" in stdout}
    check(out["launcher_world_1"]["nccl"] and not out["no_launcher"]["nccl"], out)
    print(f"16d: --gpus 2 trained on the one card in both; the launcher's run joined an "
          f"NCCL group of one rank  [{card}]")
    return out


def p16_retrieval(device, card, taxonomy_1000):
    """16e: ILSVRC val size (50,000 x 1,000, phase 5d's features), the
    database's rows over [cuda:0, cuda:0] against the replicated database
    on one device and the query blocks over both: per-query values equal,
    the rankings of every query bitwise equal; q/s of each (median of 3)."""
    import torch

    from semantic_embeddings_torch.evaluation import retrieval as R
    from semantic_embeddings_torch.hierarchy import ClassHierarchy

    hierarchy = ClassHierarchy.from_file(taxonomy_1000, id_type=int)
    feats, labels = protocol_features(50_000, 1000, 1000)
    n = len(feats)
    kwargs = dict(ks=[1, 10, 50, 100], compute_ahp=250, compute_ap=False, normalize=True,
                  block_size=2048)
    runs = {"replicated_one_device": dict(device=device),
            "queries_over_2": dict(devices=[device, device]),
            "db_sharded_over_2": dict(devices=[device, device], db_sharded=True)}
    results, rates = {}, {}
    for name, extra in runs.items():
        R.evaluate_retrieval_features(feats, labels, hierarchy, **kwargs, **extra)  # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            results[name] = R.evaluate_retrieval_features(feats, labels, hierarchy, **kwargs,
                                                          **extra)
            walls.append(time.perf_counter() - t0)
        rates[name] = n / statistics.median(walls)
    ref_means, ref_pq = results["replicated_one_device"]
    gaps = {}
    for name, (means, pq) in results.items():
        gaps[name] = max(float(np.abs(np.array(list(pq[m].values()))
                                      - np.array(list(ref_pq[m].values()))).max())
                         for m in ref_pq)
    # the database's shards rank every query as the whole database does, so
    # their metrics are the same numbers; the split query blocks take other
    # GEMM shapes, whose sums may round otherwise at near-ties
    check(results["db_sharded_over_2"][0] == ref_means and gaps["db_sharded_over_2"] == 0.0,
          ("16e db_sharded", gaps, results["db_sharded_over_2"][0], ref_means))
    check(gaps["queries_over_2"] <= 1e-6, ("16e queries over 2", gaps))
    database = torch.from_numpy(feats / np.linalg.norm(feats, axis=1, keepdims=True)).to(device)
    rank = R._db_sharded_ranker(database, [device, device], True, 250)
    differ = 0
    for start in range(0, n, 2048):
        q_index = torch.arange(start, min(start + 2048, n), device=device)
        want = R._ranked(R._similarities(database[q_index], database, True), q_index, 250)
        differ += int((rank(database[q_index], q_index) != want).any(dim=1).sum())
    print(f"16e retrieval {n} x 1000, top-k protocol: q/s "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; largest per-query gap from one device {gaps}; database-sharded rankings "
          f"differing from the replicated ones in {differ} of {n} queries  [{card}]")
    check(differ == 0, f"16e: {differ} rankings differ")
    return {"qps": rates, "rankings_differing": differ, "n": n, "per_query_gaps": gaps,
            "mAHP@250 (LCS_HEIGHT)": ref_means["AHP@250 (LCS_HEIGHT)"]}


def p16_serving(device, card, rn50_ckpt):
    """16f: the serving engine over two replicas of phase 8's ResNet-50 on
    [cuda:0, cuda:0] against one, max batch 64: the l2norm outputs of 256
    images in requests of 64 within 1e-6, img/s of each (in turns one, two,
    two, one) and the conv kernel's launches a call."""
    import torch

    from semantic_embeddings_torch.cli import serve_model
    from semantic_embeddings_torch.serving import BatchingEngine

    args = serve_model.build_parser().parse_args(
        ["--checkpoint", rn50_ckpt, "--layer", "l2norm", "--input_size", "224",
         "--device", "cuda"])
    fns = [serve_model._device_fn(serve_model.build_model_fn(args, device)[0], device, None,
                                  None, False) for _ in range(2)]
    images = np.random.default_rng(16).normal(size=(256, 224, 224, 3)).astype(np.float32)
    engines = {"one": BatchingEngine(fns[:1], (224, 224, 3), max_batch=64),
               "two": BatchingEngine(fns, (224, 224, 3), max_batch=64)}
    check(engines["two"].buckets == [2, 4, 8, 16, 32, 64], engines["two"].buckets)
    outs, rates, launches = {}, {}, {}
    for name in ("one", "two", "two", "one"):
        engine = engines[name]
        engine.warmup([64])
        with engine:
            reset_launches()
            t0 = time.perf_counter()
            outs[name] = np.concatenate([engine.predict(images[i:i + 64], timeout=120)
                                         for i in range(0, 256, 64)])
            rates.setdefault(name, []).append(256 / (time.perf_counter() - t0))
            launches[name] = read_launches()["conv3x3_bn_stats"] // 4
    err = float(np.abs(outs["two"] - outs["one"]).max())
    print(f"16f serving resnet-50 @ 224, requests of 64: img/s one device "
          f"{rates['one']}, two replicas on cuda:0 {rates['two']}; max |two - one| "
          f"{err:.3g}; conv3x3_bn_stats launches a call {launches}  [{card}]")
    check(err <= 1e-6, err)
    check(launches == {"one": RN50_CONVS, "two": 2 * RN50_CONVS}, launches)
    return {"img_per_s": rates, "max_abs_diff": err, "conv_launches_per_call": launches}


def phase16(device, card, tmp, p9_path, embedding, labels, emb_path, rn50_ckpt,
            taxonomy_1000):
    """Data parallelism on the one card (TF32 off, full width): 16a-16f."""
    import torch

    from semantic_embeddings_torch import parallel
    from semantic_embeddings_torch.models import layers
    from semantic_embeddings_torch.models.resnet import use_plain_conv_bn_stats
    from semantic_embeddings_torch.train import new_train_state

    t_phase = time.perf_counter()
    out = {}
    phase(f"16a-c resnet-50 @ 224, batch {RN50_BATCH}: {P16_STEPS} steps through fit in an "
          "NCCL group of one rank vs none (own process); phase 9's step on two gloo ranks "
          "on the card, sync and per-replica BN (two processes)")
    job = os.path.join(tmp, "p16_job.pickle")
    with open(job, "wb") as f:
        pickle.dump({"embedding": embedding, "labels": labels, "phase9": p9_path}, f)
    out_a = os.path.join(tmp, "p16a.json")
    # 16c's one-process references first, alone on the card (an f64
    # ResNet-50 step at batch 128 takes tens of GiB): _GroupedBatchNorm
    # (groups=2) through the kernels in f32, and through the plain versions
    # in f64
    p9 = torch.load(p9_path, map_location="cpu", weights_only=True)
    before = p9["before"]
    layers.set_default_bn_groups(2)
    try:
        grouped = {}
        for name, dtype in (("kernel", torch.float32), ("f64", torch.float64)):
            state, spec = rn50_state(device, 1)
            state.model.load_state_dict(before)
            if dtype == torch.float64:
                use_plain_conv_bn_stats(state.model)
                state = new_train_state(state.model.double())

            def prepare(raw, rng, train, dtype=dtype):
                return raw["x"].to(device, dtype), raw["y"].to(device)

            rn50_train_step(state, spec, prepare, embedding, plain=dtype == torch.float64)(
                state, {"x": p9["images"], "y": p9["labels"]}, 0.1, None)
            grouped[name] = {k: v.cpu() for k, v in state.model.state_dict().items()}
            del state
    finally:
        layers.set_default_bn_groups(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # then 16a's process and 16b-c's two side by side
    with ThreadPoolExecutor(2) as pool:
        run_a = pool.submit(parallel.launch, p16a_worker, 1, job, out_a)
        run_bc = pool.submit(parallel.launch, p16bc_worker, 2, job, tmp)
        run_a.result()
        run_bc.result()
    with open(out_a) as f:
        a = json.load(f)
    print(f"16a: fit alone {a['seconds']['alone_first']:.2f} s (the process's first), in a "
          f"{a['backend']} group of {a['world']} {a['seconds']['group']:.2f} s, alone again "
          f"{a['seconds']['alone']:.2f} s; {len(a['unequal'])} of {a['tensors']} "
          f"tensors differ; launches {a['launches']}  [{card}]")
    check(a["backend"] == "nccl" and a["world"] == 1, a)
    check(not a["unequal"], a["unequal"][:10])
    want = {"cosine_loss_fwd": P16_STEPS, "cosine_loss_bwd": P16_STEPS,
            "conv3x3_bn_stats": RN50_CONVS * (P16_STEPS + 1),
            "conv3x3_filter_grad": RN50_CONVS * P16_STEPS,
            "conv1x1_filter_grad": RN50_1X1 * P16_STEPS}
    check(a["launches"]["alone"] == want and a["launches"]["group"] == want, a["launches"])
    out["16a"] = a
    with open(os.path.join(tmp, "p16bc.json")) as f:
        bc = json.load(f)
    check(bc["world"] == 2 and bc["backend"] == "gloo", bc)
    print(f"16b-c: each rank's first step, not kept, {bc['warm-up']['seconds']:.2f} s")
    one_step = {"cosine_loss_fwd": 1, "cosine_loss_bwd": 1, "conv3x3_bn_stats": RN50_CONVS,
                "conv3x3_filter_grad": RN50_CONVS, "conv1x1_filter_grad": RN50_1X1}
    refs = {"sync": (p9["f64"], p9["kernel"]), "per_replica": (grouped["f64"], grouped["kernel"])}
    for mode, label in (("sync", "16b sync BN"), ("per_replica", "16c per-replica BN")):
        r = bc[mode]
        sd = torch.load(os.path.join(tmp, f"p16_{mode}.pt"), map_location="cpu",
                        weights_only=True)
        print(f"{label}: two gloo ranks on the card, {r['seconds']:.2f} s for the step "
              f"(rank 0), loss {r['loss']:.9f}, ranks equal {r['ranks_equal']}, launches "
              f"of each rank {r['launches']} (equal on both: {r['launches_equal']})  "
              f"[{card}; gloo through the host: neither NCCL nor scaling]")
        check(r["ranks_equal"], f"{label}: the ranks differ")
        check(r["launches"] == one_step and r["launches_equal"], r)
        sd_64, sd_one = refs[mode]
        r["vs_f64"] = hold_to_f64(label, before, sd_64, sd_one, sd)
        out["16b" if mode == "sync" else "16c"] = r
    del p9, before, grouped
    torch.cuda.empty_cache()

    phase("16d learn_image_embeddings --gpus 2 on the one card, without a launcher and "
          "under one of world size 1 (own processes)")
    out["16d"] = p16_cli(tmp, emb_path, card)
    phase("16e retrieval at ILSVRC val size: --db_sharded over [cuda:0, cuda:0] vs replicated")
    out["16e"] = p16_retrieval(device, card, taxonomy_1000)
    torch.cuda.empty_cache()
    phase("16f the serving engine over two replicas on [cuda:0, cuda:0] vs one device")
    out["16f"] = p16_serving(device, card, rn50_ckpt)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 16 took {out['seconds']:.1f} s")
    return out


def check_against_f64(before, model_64, model_k, model_p, label=""):
    """Holds one train step through the kernels (``model_k``) and one
    through the plain versions (``model_p``), both from the state dict
    ``before``, to the plain versions' step in f64 (``model_64``): tensor by
    tensor, in f64, the distance of each from the f64 step in units of that
    tensor's f64 update (BN running statistics: in absolute terms); the
    kernel step may be no farther than twice the plain step's farthest
    tensor.  Returns the worst and median distances."""
    sd_64, sd_k, sd_p = (m.state_dict() for m in (model_64, model_k, model_p))
    param_names = {n for n, _ in model_k.named_parameters()}
    dist = {"kernel": {}, "plain": {}}
    for n, old in before.items():
        ref = sd_64[n].double()
        scale = (ref - old.double()).abs().max().item() if n in param_names else 1.0
        for path, got in (("kernel", sd_k[n]), ("plain", sd_p[n])):
            dist[path][n] = (got.double() - ref).abs().max().item() / max(scale, 1e-30)
    out = {}
    for what, names in (("parameter", param_names), ("BN statistic", set(before) - param_names)):
        worst = {path: max(d[n] for n in names) for path, d in dist.items()}
        median = {path: statistics.median(d[n] for n in names) for path, d in dist.items()}
        far = sorted(names, key=lambda n: -dist["kernel"][n])[:3]
        print(f"{label}{what} distance from f64 (of the update for parameters): worst "
              f"kernel {worst['kernel']:.3g}, plain {worst['plain']:.3g}; median kernel "
              f"{median['kernel']:.3g}, plain {median['plain']:.3g}; farthest "
              + ", ".join(f"{n} {dist['kernel'][n]:.3g}/{dist['plain'][n]:.3g}"
                          for n in far))
        bad = [n for n in names if dist["kernel"][n] > 2 * worst["plain"] + 1e-7]
        check(not bad, [(n, dist["kernel"][n], worst["plain"]) for n in bad[:10]])
        out[what] = {"worst": worst, "median": median}
    return out


# phase 17: spatial partitioning, --profile_dir, pairwise_matrices_device.
# 17b: the CosineLoss.md CUB recipe (ResNet-50 @ 448, batch 24, bf16,
# --fused_loss) on a (1, 2) grid of two gloo ranks sharing the card
P17_SIZE, P17_BATCH, P17_STEPS = 448, CUB_BATCH, 3
#: 17d: the leaves of the tree pairwise_matrices_device runs on
P17_LEAVES = 1000


def p17_halo_kernels(device, card, CC):
    """17a: both kernels, both dtypes, with halo rows at the 448-px
    recipe's shard shapes (``checks.HALO_CASES``): each held to its plain halo
    version and to the rows of the whole-image launch
    (``checks.check_halo_shards``), and timed per call on its largest shard
    beside the whole-image launch scaled to the same rows and the shard's
    bound."""
    import torch

    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.ops import checks

    common.set_float32_precision()  # TF32 off for every check against the plain versions
    gen = torch.Generator(device=device).manual_seed(17)
    out = {}
    for case in checks.HALO_CASES:
        b, h, w, c, f, spatial = case
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            x, wt, dy = checks.conv3x3_check_inputs(case[:5], dtype, gen)
            err = checks.check_halo_shards(x, wt, dy, spatial)
            a, b_, top, bottom = checks.row_shards(x, spatial)[0]
            xs, dys = x[:, :, a:b_].contiguous(), dy[:, :, a:b_].contiguous()
            rows = b_ - a
            conv_ms = time_ms(lambda: CC._launch_conv_bn_stats(xs, wt, top, bottom), 20, 3)
            grad_ms = time_ms(lambda: CC._launch_filter_grad(xs, dys, top, bottom), 20, 3)
            whole_conv = time_ms(lambda: CC._launch_conv_bn_stats(x, wt), 20, 3)
            whole_grad = time_ms(lambda: CC._launch_filter_grad(x, dy), 20, 3)
            # the library call: conv2d_weight on the block's rows with its
            # halo rows (zeros at the image's edge) concatenated
            x_ext, wshape = CC._halo_extended(xs, top, bottom), tuple(wt.shape)
            grad_lib = time_ms(lambda: torch.nn.grad.conv2d_weight(
                x_ext, wshape, dys, padding=(0, 1)), 20, 3)
            # each input read once (the shard, its two halo rows, the
            # weight or dy), each output written once
            elem = x.element_size()
            halo_rows = (top is not None) + (bottom is not None)
            flop = 2 * b * rows * w * 9 * c * f
            peak = "bfloat16" if dtype == torch.bfloat16 else "3xtf32"
            conv_bound = bound(flop, elem * (b * c * (rows + halo_rows) * w + f * c * 9
                                             + b * f * rows * w) + 8 * f, peak)
            grad_bound = bound(flop, elem * (b * c * (rows + halo_rows) * w + b * f * rows * w)
                               + 4 * f * c * 9, peak)
            key = f"{case} {name}"
            out[key] = {**err, "shard_rows": rows, "halo_rows": halo_rows,
                        "conv3x3_bn_stats": {"ms": conv_ms, "whole_scaled_ms":
                                             whole_conv * rows / h, "bound_ms": conv_bound[0],
                                             "bound_by": conv_bound[1]},
                        "conv3x3_filter_grad": {"ms": grad_ms, "whole_scaled_ms":
                                                whole_grad * rows / h, "bound_ms": grad_bound[0],
                                                "bound_by": grad_bound[1],
                                                "library_ms": grad_lib}}
            print(f"17a {key}: shard of {rows} rows + {halo_rows} halo rows: conv+stats "
                  f"{conv_ms:.4f} ms (whole image scaled {whole_conv * rows / h:.4f}, bound "
                  f"{conv_bound[0]:.4f}), filter grad {grad_ms:.4f} ms (whole scaled "
                  f"{whole_grad * rows / h:.4f}, conv2d_weight {grad_lib:.4f}, bound "
                  f"{grad_bound[0]:.4f}); y vs plain "
                  f"{err['y_vs_plain']:.3g}, y bitwise the whole image's "
                  f"{err['y_vs_whole_bitwise']}, sums vs whole {err['s_vs_whole_of_abs']:.3g} / "
                  f"{err['ss_vs_whole_of_abs']:.3g} of sum |y|, dw vs whole "
                  f"{err['dw_vs_whole_of_max']:.3g} of max  [{card}]")
            check(err["y_vs_whole_bitwise"], (key, err))
    return out


def p17b_worker(job_path, out_path):
    """17b, one of two ranks on the one card (gloo), folded into a (1, 2)
    grid: from the job's weights, one f32 step, then the recipe's bf16
    steps, each on this rank's rows of every image; the launches of each
    step (all and with halo rows), the losses, the seconds; rank 0 saves
    the state after the f32 step and after the first bf16 step."""
    import torch

    from semantic_embeddings_torch import parallel
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.ops import conv3x3 as CC

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    parallel.initialize_distributed(device, backend="gloo")
    common.set_float32_precision()
    parallel.set_grid(parallel.get_grid(2))
    job = torch.load(job_path, map_location="cpu", weights_only=False)

    def prepare(raw, rng, train):
        return raw["x"].to(device), raw["y"].to(device)

    batch = parallel.shard_batch({"x": job["images"], "y": job["labels"]})
    out = {"world": parallel.world_size(), "grid": list(parallel.current_grid().shape),
           "backend": torch.distributed.get_backend(), "steps": {}}
    for dtype, steps in (("f32", 1), ("bf16", P17_STEPS)):
        state, spec = rn50_state(device, 17)
        state.model.load_state_dict(job["before"])
        step = rn50_train_step(state, spec, prepare, job["embedding"],
                               autocast_dtype=torch.bfloat16 if dtype == "bf16" else None)
        out["steps"][dtype] = []
        for i in range(steps):
            reset_launches()
            CC.launches_conv_bn_stats_halo = CC.launches_filter_grad_halo = 0
            t0 = time.perf_counter()
            state, m = step(state, batch, 0.1, None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {**read_launches(),
                        "conv3x3_bn_stats_halo": CC.launches_conv_bn_stats_halo,
                        "conv3x3_filter_grad_halo": CC.launches_filter_grad_halo}
            counts = torch.tensor(list(launches.values()), dtype=torch.float64)
            out["steps"][dtype].append({
                "loss": float(m["loss"]), "seconds": seconds, "launches": launches,
                "launches_equal_on_ranks": bool(
                    (parallel.sum_over_group(counts) == 2 * counts).all())})
            if i == 0 and parallel.rank() == 0:
                torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                           f"{out_path}.{dtype}.pt")
        sd = state.model.state_dict()
        flat = torch.cat([v.reshape(-1).float() for v in sd.values()])
        out[f"ranks_equal_{dtype}"] = parallel.sum_over_group(
            (flat - parallel.sum_over_group(flat) / 2).abs().max()).item() == 0.0
        del state, step
    parallel.set_grid(None)
    if parallel.rank() == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    parallel.finalize_distributed()


def p17_spatial_recipe(device, card, tmp, embedding):
    """17b: the recipe on the (1, 2) grid of two gloo ranks against the same
    steps in one process from the same weights and batch.  One f32 step
    (TF32 off) first, where the grid must be the one process's step: its
    loss within 1e-5 relative, its worst parameter no farther from the f64
    step than 1.5 times the one-process step's worst, its worst running
    statistic no farther than twice the one-process step's (plus 1e-7) and
    the statistics within 1e-5 relative of the one-process step's (16b's
    bounds: f32 sums over other partitions of the pixels put two
    data-parallel ranks' statistics 1.0-1.4e-6 from one process's in 16b).
    Then the recipe's bf16 steps, which two runs that agree in f32 do not
    reproduce: bf16 rounds y to 8 bits, and cuDNN's bf16 convolutions of a
    block of rows may sum in another order than of the whole image, so the
    losses differ by a few 1e-4 and each step's update of some tensors is
    mostly rounding (a worst tensor 1.8-3.4 units of its update from f64 in
    either run).  So bf16 is held to f64 by statistics that rounding does
    not swing: the first loss within 2^-8 (bf16's unit) of the f64 loss,
    the median parameter no farther from the f64 step than 1.5 times the
    one-process step's median, the worst than 3 times its worst, the worst
    statistic than twice its worst (plus 1e-7);
    every step 16 halo launches of each conv kernel on each rank; seconds a
    step (gloo: the halos go through the host, no speed claim)."""
    import torch

    from semantic_embeddings_torch import parallel
    from semantic_embeddings_torch.models.resnet import use_plain_conv_bn_stats
    from semantic_embeddings_torch.train import new_train_state

    gen = torch.Generator().manual_seed(17)
    images = torch.randn((P17_BATCH, P17_SIZE, P17_SIZE, 3), generator=gen)
    labels = torch.randint(0, 100, (P17_BATCH,), generator=gen)
    state, spec = rn50_state(device, 17)
    before = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    del state
    job = os.path.join(tmp, "p17b_job.pt")
    torch.save({"before": before, "images": images, "labels": labels,
                "embedding": embedding}, job)

    def prepare(raw, rng, train, dtype=torch.float32):
        return raw["x"].to(device, dtype), raw["y"].to(device)

    batch = {"x": images, "y": labels}
    one = {}
    for dtype, steps in (("f32", 1), ("bf16", P17_STEPS)):
        state, spec = rn50_state(device, 17)
        state.model.load_state_dict(before)
        step = rn50_train_step(state, spec, prepare, embedding,
                               autocast_dtype=torch.bfloat16 if dtype == "bf16" else None)
        one[dtype] = {"losses": [], "seconds": []}
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch, 0.1, None)
            torch.cuda.synchronize()
            one[dtype]["seconds"].append(time.perf_counter() - t0)
            one[dtype]["losses"].append(float(m["loss"]))
            if i == 0:
                one[dtype]["state"] = {k: v.cpu().clone()
                                       for k, v in state.model.state_dict().items()}
        del state, step
    torch.cuda.empty_cache()
    # the f64 step through the plain versions, the yardstick of both
    state, spec = rn50_state(device, 17)
    state.model.load_state_dict(before)
    use_plain_conv_bn_stats(state.model)
    state = new_train_state(state.model.double())
    _, m64 = rn50_train_step(state, spec, lambda r, g, t: prepare(r, g, t, torch.float64),
                             embedding, plain=True)(state, batch, 0.1, None)
    loss_64 = float(m64["loss"])
    sd_64 = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    out_path = os.path.join(tmp, "p17b.json")
    t0 = time.perf_counter()
    parallel.launch(p17b_worker, 2, job, out_path)
    launch_s = time.perf_counter() - t0
    with open(out_path) as f:
        grid = json.load(f)
    check(grid["world"] == 2 and grid["grid"] == [1, 2] and grid["backend"] == "gloo", grid)
    check(grid["ranks_equal_f32"] and grid["ranks_equal_bf16"], "17b: the ranks' states differ")
    params = [n for n in before if "running_" not in n]
    result = {"loss_f64": loss_64, "launch_seconds": launch_s}
    for dtype in ("f32", "bf16"):
        sd_grid = torch.load(f"{out_path}.{dtype}.pt", map_location="cpu", weights_only=True)
        sd_one = one[dtype]["state"]
        losses = [s["loss"] for s in grid["steps"][dtype]]
        gap = abs(losses[0] - one[dtype]["losses"][0]) / abs(one[dtype]["losses"][0])
        from_64 = {"grid": abs(losses[0] - loss_64) / abs(loss_64),
                   "one_process": abs(one[dtype]["losses"][0] - loss_64) / abs(loss_64)}
        ref = distances_from_f64(before, sd_64, sd_one)
        new = distances_from_f64(before, sd_64, sd_grid)
        worst = {"grid": max(new[n] for n in params), "one_process": max(ref[n] for n in params)}
        median = {"grid": statistics.median(new[n] for n in params),
                  "one_process": statistics.median(ref[n] for n in params)}
        stats = [n for n in before if "running_" in n]
        worst_stats = {"grid": max(new[n] for n in stats),
                       "one_process": max(ref[n] for n in stats)}
        stats_gap = max((sd_grid[n] - sd_one[n]).abs().max().item()
                        / max(sd_one[n].abs().max().item(), 1e-30)
                        for n in before if "running_" in n)
        print(f"17b {dtype}: losses of the grid {losses}, one process {one[dtype]['losses']}, "
              f"f64 {loss_64}; first step's gap {gap:.3g} relative, from f64 grid "
              f"{from_64['grid']:.3g} / one process {from_64['one_process']:.3g}; worst "
              f"parameter distance from the f64 step (units of its update) grid "
              f"{worst['grid']:.4g}, one process {worst['one_process']:.4g} (median "
              f"{median['grid']:.4g} / {median['one_process']:.4g}); running "
              f"statistics from f64 grid {worst_stats['grid']:.3g}, one process "
              f"{worst_stats['one_process']:.3g}, vs one process {stats_gap:.3g} relative")
        check(worst_stats["grid"] <= 2 * worst_stats["one_process"] + 1e-7,
              (dtype, worst_stats))
        if dtype == "f32":
            check(worst["grid"] <= 1.5 * worst["one_process"], (dtype, worst))
            check(stats_gap <= 1e-5, ("17b f32 statistics", stats_gap))
            check(gap <= 1e-5, ("17b f32 loss", gap))
        else:
            check(median["grid"] <= 1.5 * median["one_process"], (dtype, median))
            check(worst["grid"] <= 3 * worst["one_process"], (dtype, worst))
            check(from_64["grid"] <= 2.0**-8, ("17b bf16 loss", from_64))
        result[dtype] = {"losses": losses, "one_process_losses": one[dtype]["losses"],
                         "first_loss_gap": gap, "first_loss_vs_f64": from_64,
                         "worst_param_vs_f64": worst, "median_param_vs_f64": median,
                         "statistics_relative_gap": stats_gap,
                         "worst_statistic_vs_f64": worst_stats,
                         "seconds": [s["seconds"] for s in grid["steps"][dtype]],
                         "one_process_seconds": one[dtype]["seconds"]}
    want = {"cosine_loss_fwd": 1, "cosine_loss_bwd": 1, "conv3x3_bn_stats": RN50_CONVS,
            "conv3x3_filter_grad": RN50_CONVS, "conv1x1_filter_grad": 0,
            "conv3x3_bn_stats_halo": RN50_CONVS, "conv3x3_filter_grad_halo": RN50_CONVS}
    for dtype in ("f32", "bf16"):
        for i, s in enumerate(grid["steps"][dtype]):
            print(f"17b {dtype} step {i + 1}: {s['seconds']:.3f} s on the grid (rank 0), "
                  f"{one[dtype]['seconds'][i]:.3f} s in one process; launches of each rank "
                  f"{s['launches']} (equal on both: {s['launches_equal_on_ranks']})  "
                  f"[{card}; gloo through the host: not a speed claim]")
            check(s["launches"] == want and s["launches_equal_on_ranks"], s)
    result["launches"] = grid["steps"]["bf16"][-1]["launches"]
    return result


def p17_profile(card, tmp, emb_path):
    """17c: ``learn_image_embeddings --profile_dir`` on slice 1's recipe for
    2 epochs (40 steps): the window (10, 30) closes with JAX's message,
    rank 0's trace file names the cosine kernels."""
    from semantic_embeddings_torch.cli import learn_image_embeddings

    trace_dir = os.path.join(tmp, "p17_trace")
    argv = ["--dataset", DATASET, "--data_root", tmp, "--embedding", emb_path,
            "--architecture", "resnet-110-wfc", "--loss", "inv_corr", "--cls_weight", "0.1",
            "--fused_loss", "--lr_schedule", "SGDR", "--sgdr_max_lr", "0.5",
            "--batch_size", str(BATCH), "--epochs", "2", "--device", "cuda",
            "--no_progress", "--profile_dir", trace_dir]
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = learn_image_embeddings.main(argv)
    seconds = time.perf_counter() - t0
    steps = 2 * N_TRAIN // BATCH
    check(state.step == steps and steps >= 31, state.step)
    check(f"Wrote device trace to {trace_dir}" in tee.buf.getvalue(), "no trace message")
    path = os.path.join(trace_dir, "trace_rank0.json")
    check(os.path.exists(path), path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    cosine = sorted(k for k in kernels if "cosine" in k)
    print(f"17c: {steps} steps in {seconds:.1f} s; trace {os.path.getsize(path)} bytes, "
          f"{len(events)} events, {len(kernels)} kernel names, the cosine kernels {cosine}  "
          f"[{card}]")
    check(len(cosine) >= 2, cosine)
    return {"steps": steps, "seconds": seconds, "trace_bytes": os.path.getsize(path),
            "events": len(events), "cosine_kernels": cosine}


def p17_pairwise(device, card):
    """17d: ``pairwise_matrices_device`` on the card for a tree of
    ``P17_LEAVES`` leaves from the seed, against the host
    ``pairwise_matrices`` (within 1e-7) and the same function on the CPU
    (bitwise)."""
    from semantic_embeddings_torch.hierarchy import ClassHierarchy, pairwise_matrices
    from semantic_embeddings_torch.hierarchy.vectorized import pairwise_matrices_device

    rng = np.random.default_rng(17)
    inner = 200  # a random tree of inner nodes under root 0, the leaves below
    lines = [f"{int(rng.integers(0, max(1, i // 2)))} {i}" for i in range(1, inner)]
    lines += [f"{int(rng.integers(inner // 4, inner))} {inner + j}" for j in range(P17_LEAVES)]
    path = os.path.join(tempfile.mkdtemp(prefix="p17d_"), "tree.parent-child.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    hierarchy = ClassHierarchy.from_file(path, id_type=int)
    leaves = sorted(hierarchy.leaves())
    check(len(leaves) >= P17_LEAVES and hierarchy.is_tree(), len(leaves))
    t0 = time.perf_counter()
    card_m = pairwise_matrices_device(hierarchy, leaves, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_m = pairwise_matrices_device(hierarchy, leaves, device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_m = pairwise_matrices(hierarchy, leaves)
    host_s = time.perf_counter() - t0
    out = {"leaves": len(leaves), "seconds": {"card": card_s, "cpu": cpu_s, "host": host_s}}
    for key in ("lcs_height", "wup"):
        bitwise = bool(np.array_equal(card_m[key], cpu_m[key]))
        err = float(np.abs(card_m[key] - host_m[key]).max())
        out[key] = {"bitwise_vs_cpu": bitwise, "vs_host": err}
        print(f"17d {key} ({len(leaves)} x {len(leaves)}): card bitwise the CPU's {bitwise}, "
              f"max |card - host f64| {err:.3g}; {card_s:.3f} s on the card, {cpu_s:.3f} s "
              f"on the CPU, host path {host_s:.3f} s  [{card}]")
        check(bitwise and err <= 1e-7, (key, bitwise, err))
    return out


def phase17(device, card, tmp, embedding, emb_path, CC):
    """Spatial partitioning, --profile_dir and pairwise_matrices_device:
    17a-17d."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    phase("17a the conv kernels with halo rows at the 448-px recipe's shard shapes "
          "(S = 2, stage 4 also S = 4), f32 and bf16, vs plain and vs the whole image "
          "(TF32 off)")
    out["17a"] = p17_halo_kernels(device, card, CC)
    torch.cuda.empty_cache()
    phase(f"17b the CUB recipe (ResNet-50 @ {P17_SIZE}, batch {P17_BATCH}, bf16, "
          "--fused_loss) on a (1, 2) grid of two gloo ranks on the card vs one process")
    out["17b"] = p17_spatial_recipe(device, card, tmp, embedding)
    torch.cuda.empty_cache()
    phase("17c learn_image_embeddings --profile_dir on slice 1's recipe")
    out["17c"] = p17_profile(card, tmp, emb_path)
    phase(f"17d pairwise_matrices_device, a {P17_LEAVES}-leaf tree")
    out["17d"] = p17_pairwise(device, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 took {out['seconds']:.1f} s")
    return out


def conv1x1_phase(device, card):
    """Phase 4b: the 1x1 convs' f32 weight-gradient kernel against f64 (and
    bitwise over two launches) at its ragged cases, a misaligned operand
    and ResNet-50's 15 shapes at 224 px, batch 128, TF32 off; each timed
    beside ``conv2d_weight`` (cuDNN, the call it replaces) and its bound; a
    step's sum over the 36 convs; and the kernel's launches by path: 36 in
    an f32 ResNet-50 train step (and with ``remat``), none in a bf16 step,
    an inference forward, an exported program's call or a train step of
    the other families, and the op not taken under a spatial grid; and the
    host time the op adds to a host-paced ResNet-50 step.  The
    main path's runs (phases 8, 12, 13, 14e, 15, 16, 17) count the kernel's
    launches beside the other kernels' (``read_launches``)."""
    import torch
    from semantic_embeddings_torch.models import build_network
    from semantic_embeddings_torch.models import resnet as rn
    from semantic_embeddings_torch.ops import checks
    from semantic_embeddings_torch.ops import conv1x1 as c1
    from semantic_embeddings_torch.parallel import spatial

    gen = torch.Generator(device=device).manual_seed(0)
    out = {"checks": {}, "by_shape": {}, "launches": {}}
    buf = torch.randn(1 + 2 * 64 * 8 * 8, generator=gen, device=device)
    cases = [(xy, 1, f"misaligned {tuple(xy[0].shape)}")
             for xy in [(buf[1:].view(2, 64, 8, 8),
                         torch.randn(2, 128, 8, 8, generator=gen, device=device))]]
    cases += [(checks.conv1x1_check_inputs(*case, gen), case[-1], f"ragged {case}")
              for case in checks.CONV1X1_RAGGED_CASES]
    for (x, dy), stride, label in cases:
        r = checks.conv1x1_check_against_f64(x, dy, stride)
        out["checks"][label] = {**r, "instance": c1.instance(x, dy, stride)}
        print(f"{label}: {out['checks'][label]}")
    sums = {"ms": 0.0, "device_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (c, f, ho, stride), count in checks.RESNET50_1X1_SHAPES:
        x, dy = checks.conv1x1_check_inputs(RN50_BATCH, c, f, ho * stride, ho * stride, stride, gen)
        r = checks.conv1x1_check_against_f64(x, dy, stride)
        ms = time_ms(lambda: c1._launch_filter_grad(x, dy, stride), 20, 3)
        dev, dev_record = device_ms(lambda: c1._launch_filter_grad(x, dy, stride), 5)
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(x, (f, c, 1, 1), dy, stride=stride),
                         20, 3)
        pixels = RN50_BATCH * ho * ho
        bound_ms, bound_by = bound(2 * pixels * c * f, 4 * pixels * (c + f) + 4 * c * f, "3xtf32")
        key = f"({c}, {f}, {ho * ho}, {stride})"
        out["by_shape"][key] = {
            "calls_a_step": count, "ms": ms, "device_ms": dev, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "instance": c1.instance(x, dy, stride), "splits": c1.splits(x, dy, stride)[0],
            "device_ms_by_kernel": dev_record["by_kernel_ms"], **r}
        for k, v in (("ms", ms), ("device_ms", dev), ("library_ms", lib_ms),
                     ("bound_ms", bound_ms)):
            sums[k] += count * v
        print(f"time 1x1 (C, F, Ho*Wo, stride) {key} x{count}: kernel {ms:.4f} ms (device "
              f"{dev:.4f} ms), conv2d_weight {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), kernel at {bound_ms / ms:.3f} of it; dw from f64 "
              f"{r['dw_vs_f64_of_max']:.2e} of max |dw| (cuDNN {r['plain_dw_vs_f64_of_max']:.2e});"
              f" {out['by_shape'][key]['instance']}  [{card}]")
        del x, dy
    torch.cuda.empty_cache()
    out["step_sums"] = sums
    print(f"step sum 1x1 (36 convs): kernel {sums['ms']:.4f} ms (device {sums['device_ms']:.4f}"
          f" ms), conv2d_weight {sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms, "
          f"kernel at {sums['bound_ms'] / sums['ms']:.3f} of it  [{card}]")

    # host time a step: ResNet-50 f32 train steps at batch 2, 64 px, where
    # the host sets the pace (the issue time is the step's time), with the
    # blocks' 1x1 convs through the op and through their own calls
    model = build_network(10, "resnet-50", generator=torch.Generator().manual_seed(0)).module
    model = model.to(device)
    x = torch.randn(2, 64, 64, 3, generator=gen, device=device)
    blocks = [m for m in model.modules() if isinstance(m, rn._Block)]
    routes = {"own": lambda conv, x_: conv(x_), "op": c1.conv1x1}

    def step_ms(route, n=20):
        for b in blocks:
            b.conv_1x1 = routes[route]
        for _ in range(3):
            model(x).sum().backward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model(x).sum().backward()
        issued = time.perf_counter()
        torch.cuda.synchronize()
        return (issued - t0) / n * 1e3, (time.perf_counter() - t0) / n * 1e3

    # the host's time swings by several ms between readings: eight of them,
    # alternating, and the difference of each adjacent pair
    host = {"own": [], "op": []}
    for route in ("own", "op", "op", "own") * 2:
        host[route].append(step_ms(route))
    pairs = [op[1] - own[1] for own, op in zip(host["own"], host["op"])]
    out["host_ms_a_step"] = {"own_issue_wall_ms": host["own"], "op_issue_wall_ms": host["op"],
                             "op_minus_own_ms": pairs}
    print(f"resnet-50 f32 step at batch 2, 64 px (host-paced), ms (issue, wall): 1x1 convs "
          f"through the op {host['op']}, through their own calls {host['own']}; the op adds "
          f"{statistics.median(pairs):.3f} ms of host time a step ({RN50_1X1} calls; pairs "
          f"{', '.join(f'{d:.3f}' for d in pairs)})  [{card}]")
    del model, x, blocks

    def launches(arch, size=64, train=True, remat=False, autocast=False, export=False):
        model = build_network(10, arch, generator=torch.Generator().manual_seed(0),
                              remat=remat).module.to(device)
        x = torch.randn(2, size, size, 3, generator=gen, device=device)
        before = c1.launches_filter_grad
        if export:
            model.eval()
            with torch.no_grad():
                torch.export.export(model, (x,)).module()(x)
        elif not train:
            with torch.no_grad():
                model(x)
        else:
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
                loss = model(x).float().sum()
            loss.backward()
        torch.cuda.synchronize()
        return c1.launches_filter_grad - before

    runs = {"resnet-50 f32 step": (("resnet-50",), {}, 36),
            "resnet-50 f32 step, remat": (("resnet-50",), {"remat": True}, 36),
            "rn18 f32 step (4 projection shortcuts)": (("rn18",), {}, 4),
            "resnet-50 bf16 step": (("resnet-50",), {"autocast": True}, 0),
            "resnet-50 inference forward": (("resnet-50",), {"train": False}, 0),
            "resnet-50 exported program's call": (("resnet-50",), {"export": True}, 0),
            "densenet-100-12 f32 step": (("densenet-100-12", 32), {}, 0),
            "nasnet-a f32 step": (("nasnet-a", 32), {}, 0),
            "resnet-110-wfc f32 step": (("resnet-110-wfc", 32), {}, 0),
            "wrn-28-10 f32 step": (("wrn-28-10", 32), {}, 0)}
    for label, (args, kwargs, want) in runs.items():
        out["launches"][label] = launches(*args, **kwargs)
        print(f"1x1 filter-gradient launches, {label}: {out['launches'][label]} (want {want})")
        check(out["launches"][label] == want, (label, out["launches"][label], want))
    conv = rn.BottleneckBlock(256, 128, stride=2, project=True).to(device).conv_sc
    x = torch.randn(2, 256, 8, 8, device=device)
    before = spatial.set_grid(spatial.Grid(2, 2, 0, groups=False))
    try:
        out["launches"]["spatial grid: op taken"] = c1.engages(conv, x)
    finally:
        spatial.set_grid(before)
    check(c1.engages(conv, x) and not out["launches"]["spatial grid: op taken"],
          "the 1x1 op's choice under a spatial grid")
    print("1x1 op under a (1, 2) spatial grid: not taken (the conv's own call)")
    return out


def depthwise_phase(device, card):
    """Phase 4c: the three depthwise kernels (forward, input gradient,
    weight gradient) against f64, and dw bitwise over two launches, at the
    op's ragged cases and NASNet-A Large's 23 depthwise shapes at 224 px,
    batch 128, TF32 off; at those shapes each pass's device time (profiler)
    and event time a call beside its bound, the op's plain version on the
    card (``F.pad`` + ATen) and ATen's call as the port made it before
    (``library_ms``: ``F.conv2d`` with its symmetric padding, or ``F.pad``
    first), and a step's sums over the 220 layers; each wrapper launching
    its one kernel, named as the benchmark's readers expect; and the
    launches of a NASNet-A step at 64 px: 220 of each kernel, no ATen
    depthwise kernel, none under autocast or a spatial grid."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from semantic_embeddings_torch.models import build_network, nasnet
    from semantic_embeddings_torch.ops import checks
    from semantic_embeddings_torch.ops import depthwise as dwc
    from semantic_embeddings_torch.parallel import spatial

    gen = torch.Generator(device=device).manual_seed(0)
    out = {"checks": {}, "by_shape": {}, "launches": {}}
    for case in checks.DEPTHWISE_RAGGED_CASES:
        r = checks.depthwise_check_against_f64(*checks.depthwise_check_inputs(*case, gen), case[-1])
        out["checks"][f"ragged {case}"] = r
        print(f"depthwise ragged {case}: {r}")
    passes = ("forward", "input_grad", "grad_weight")
    sums = {p: {"device_ms": 0.0, "ms": 0.0, "plain_device_ms": 0.0, "library_device_ms": 0.0,
                "bound_ms": 0.0} for p in passes}
    for (c, k, s, h), count in checks.NASNET_SHAPES:
        x, wt, dy = checks.depthwise_check_inputs(RN50_BATCH, c, h, h, k, s, gen)
        r = checks.depthwise_check_against_f64(x, wt, dy, s)
        ho = dwc.out_size(h, s)
        pb, pa = dwc.same_pads(h, k, s)  # square maps: the same in both axes
        sym = pb == pa

        def lib_input(xs=x.shape):
            if sym:
                return torch.nn.grad.conv2d_input(xs, wt, dy, s, pb, groups=c)
            padded = (xs[0], c, h + pb + pa, h + pb + pa)
            return torch.nn.grad.conv2d_input(padded, wt, dy, s, groups=c)[:, :, pb:pb + h,
                                                                             pb:pb + h]

        calls = {
            "forward": (lambda: dwc._launch_forward(x, wt, s),
                        lambda: dwc._plain_forward(x, wt, s),
                        (lambda: F.conv2d(x, wt, None, s, pb, groups=c)) if sym else
                        (lambda: F.conv2d(F.pad(x, (pb, pa, pb, pa)), wt, None, s, groups=c))),
            "input_grad": (lambda: dwc._launch_input_grad(dy, wt, h, h, s),
                           lambda: dwc._plain_input_grad(dy, wt, h, h, s), lib_input),
            "grad_weight": (lambda: dwc._launch_grad_weight(x, dy, k, s),
                            lambda: dwc._plain_grad_weight(x, dy, k, s),
                            (lambda: torch.nn.grad.conv2d_weight(x, wt.shape, dy, s, pb,
                                                                 groups=c)) if sym else
                            (lambda: torch.nn.grad.conv2d_weight(
                                F.pad(x, (pb, pa, pb, pa)), wt.shape, dy, s, groups=c)))}
        xs, ys, ws = x.numel(), dy.numel(), wt.numel()
        nbytes = {"forward": 4 * (xs + ws + ys), "input_grad": 4 * (ys + ws + xs),
                  "grad_weight": 4 * (xs + ys + ws)}
        key = f"({c}, {k}, {s}, {h})"
        row = {"layers_a_step": count, **r}
        for p in passes:
            kernel, plain, lib = calls[p]
            dev, record = device_ms(kernel, 20)
            names = list(record["by_kernel_ms"])
            check(len(names) == 1 and dwc.KERNEL_NAMES[p] in names[0], (p, names))
            ms = time_ms(kernel, 20, 3)
            plain_dev = device_ms(plain, 20)[0]
            lib_dev = device_ms(lib, 20)[0]
            bound_ms, bound_by = bound(2 * k * k * ys, nbytes[p], "float32")
            row[p] = {"device_ms": dev, "ms": ms, "plain_device_ms": plain_dev,
                      "library_device_ms": lib_dev, "bound_ms": bound_ms, "bound_by": bound_by,
                      "share_of_bound": bound_ms / dev, "kernel": names[0]}
            for field in sums[p]:
                sums[p][field] += count * row[p][field]
        out["by_shape"][key] = row
        print(f"depthwise (C, k, stride, H) {key} x{count}, batch {RN50_BATCH}: "
              + "; ".join(f"{p} {row[p]['device_ms']:.4f} ms device ({row[p]['ms']:.4f} event), "
                          f"bound {row[p]['bound_ms']:.4f} ({row[p]['share_of_bound']:.3f}), "
                          f"plain {row[p]['plain_device_ms']:.4f}, ATen "
                          f"{row[p]['library_device_ms']:.4f}" for p in passes)
              + f"; from f64 y {r['y_vs_f64_of_max']:.2e} dx {r['dx_vs_f64_of_max']:.2e} dw "
              f"{r['dw_vs_f64_of_max']:.2e} (ATen {r['aten_y_vs_f64_of_max']:.2e} / "
              f"{r['aten_dx_vs_f64_of_max']:.2e} / {r['aten_dw_vs_f64_of_max']:.2e})  [{card}]")
        del x, wt, dy
    torch.cuda.empty_cache()
    out["step_sums"] = sums
    for p in passes:
        t = sums[p]
        print(f"depthwise step sum {p} (220 layers): kernels {t['device_ms']:.3f} ms device "
              f"({t['ms']:.3f} event), bound {t['bound_ms']:.3f} ms "
              f"({t['bound_ms'] / t['device_ms']:.3f} of it), plain {t['plain_device_ms']:.3f}, "
              f"ATen {t['library_device_ms']:.3f}  [{card}]")
    total = {f: sum(sums[p][f] for p in passes) for f in sums["forward"]}
    out["step_total"] = total
    print(f"depthwise step total: kernels {total['device_ms']:.3f} ms device, bound "
          f"{total['bound_ms']:.3f} ms ({total['bound_ms'] / total['device_ms']:.3f} of it), "
          f"ATen {total['library_device_ms']:.3f}  [{card}]")

    # a NASNet-A forward and backward at 64 px, batch 2: every depthwise
    # conv through the op, under the profiler; then bf16 autocast and a
    # spatial grid keep ATen's call
    model = build_network(10, "nasnet-a", generator=torch.Generator().manual_seed(0)).module
    model = model.to(device)
    img = torch.randn(2, 64, 64, 3, generator=gen, device=device)

    def counters():
        return (dwc.launches_forward, dwc.launches_input_grad, dwc.launches_grad_weight)

    model(img).float().sum().backward()
    torch.cuda.synchronize()
    before = counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model(img).float().sum().backward()
        torch.cuda.synchronize()
    step = [a - b for a, b in zip(counters(), before)]
    kernels = {e.key: e.count for e in prof.key_averages() if "depthwise" in e.key}
    ours = {p: sum(n for key, n in kernels.items() if dwc.KERNEL_NAMES[p] in key)
            for p in passes}
    aten = {key: n for key, n in kernels.items() if "conv_depthwise2d" in key
            and not any(name in key for name in dwc.KERNEL_NAMES.values())}
    out["launches"]["f32 step"] = {"counters": step, "profiled": ours, "aten": aten}
    print(f"nasnet-a f32 step at 64 px: launch counters {step}, profiled {ours}, ATen's "
          f"depthwise kernels {aten or 'none'}")
    check(step == [220, 220, 220] and list(ours.values()) == [220, 220, 220] and not aten,
          (step, ours, aten))
    before = counters()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = model(img).float().sum()
    loss.backward()
    torch.cuda.synchronize()
    out["launches"]["bf16 step"] = [a - b for a, b in zip(counters(), before)]
    conv = next(m for m in model.modules() if isinstance(m, nasnet.SepConvBlock)).dw0
    x = torch.randn(2, conv.in_channels, 8, 8, device=device)
    previous = spatial.set_grid(spatial.Grid(2, 2, 0, groups=False))
    try:
        out["launches"]["spatial grid: op taken"] = dwc.engages(conv, x)
    finally:
        spatial.set_grid(previous)
    print(f"nasnet-a bf16 step: launches {out['launches']['bf16 step']} (want none); under a "
          f"(1, 2) spatial grid the op taken: {out['launches']['spatial grid: op taken']}")
    check(out["launches"]["bf16 step"] == [0, 0, 0] and dwc.engages(conv, x)
          and not out["launches"]["spatial grid: op taken"], out["launches"])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile the train step (f32 and bf16) and "
                             "time the host's pieces of it; tables go to DIR")
    profile_dir = parser.parse_args(argv).profile
    import torch

    # -- 1. identify the card -----------------------------------------
    phase("1 card")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)

    sys.path.insert(0, ROOT)
    from semantic_embeddings_torch import _build
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.ops import checks
    from semantic_embeddings_torch.ops import conv3x3 as CC
    from semantic_embeddings_torch.ops import cosine_loss as C

    # -- 2. build ------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.build, sources))
    C._kernels()
    CC._kernels()
    print(f"kernels {sources} built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, (seconds, log) in _build.build_logs.items():
        print(f"built {name} in {seconds:.2f} s\n{log.strip()}")

    # -- 3. cosine-loss kernels against their plain versions -----------
    phase("3 cosine-loss kernels vs plain")
    gen = torch.Generator(device=device).manual_seed(0)
    err = {("fwd", torch.float32): 0.0, ("bwd", torch.float32): 0.0,
           ("fwd", torch.bfloat16): 0.0, ("bwd", torch.bfloat16): 0.0}
    path_inputs = {}
    for (b, d), zero_rows in C.CHECK_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            z, t, g = C.check_inputs((b, d), dtype, gen, zero_rows)
            # raises unless both kernels match the plain versions within
            # C.CHECK_TOL (stated and reasoned there)
            e_f, e_b = C.check_against_plain(z, t, g)
            err["fwd", dtype] = max(err["fwd", dtype], e_f)
            err["bwd", dtype] = max(err["bwd", dtype], e_b)
            print(f"({b}, {d}) {str(dtype)[6:]}: max |loss err| {e_f:.3g}, "
                  f"max |dz err| {e_b:.3g}")
            if (b, d) == (100, 100):
                path_inputs[dtype] = (z, t, g)

    # Per call, CUDA events around it (what a caller waits: at this size
    # the device mostly waits for the host's launch), and the device time
    # of its kernels alone (torch.profiler).
    times, dev_times, dev_records, cos_bound = {}, {}, {}, {}
    for dtype, (z, t, g) in path_inputs.items():
        name = str(dtype)[6:]
        # each input read once, each output written once; ~4 operations an
        # element forward (|z|^2 and <z, t>), ~6 backward
        zb, b_rows = z.numel() * z.element_size(), z.shape[0]
        cos_bound["fwd", dtype] = bound(4 * z.numel(), 2 * zb + 4 * b_rows, "float32")
        cos_bound["bwd", dtype] = bound(6 * z.numel(), 3 * zb + 4 * b_rows, "float32")
        calls = {
            "fwd": (lambda: C._launch_forward(z, t), lambda: C._plain_forward(z, t)),
            "bwd": (lambda: C._launch_backward(z, t, g),
                    lambda: C._plain_backward(z, t, g)),
            "fwd+bwd": (lambda: (C._launch_forward(z, t), C._launch_backward(z, t, g)),
                        lambda: (C._plain_forward(z, t), C._plain_backward(z, t, g))),
        }
        for part, (kernel, plain) in calls.items():
            times[part, dtype] = (time_ms(kernel), time_ms(plain))
            (kd, kr), (pd, pr) = device_ms(kernel), device_ms(plain)
            dev_times[part, dtype] = (kd, pd)
            dev_records[part, dtype] = {"kernel": kr, "plain": pr}
            k, p = times[part, dtype]
            print(f"time (100, 100) {name} {part}: per call kernel {k * 1e3:.2f} us, "
                  f"plain {p * 1e3:.2f} us; device time kernel {kd * 1e3:.2f} us, "
                  f"plain {pd * 1e3:.2f} us" + (
                      f"; bound {cos_bound[part, dtype][0] * 1e3:.4f} us "
                      f"({cos_bound[part, dtype][1]})" if (part, dtype) in cos_bound
                      else "") + f"  [{card}]")

    # The library call of the same per-row function: cosine_embedding_loss
    # gives 1 - cos(z, t), which for the unit rows t is the kernel's
    # 1 - <z/|z|, t>; forward, and forward + backward through autograd (f32).
    # Beside it the launch floor: the device time of an empty kernel
    # (torch.cuda._sleep(0), one kernel that spins for zero cycles).
    z, t, g = path_inputs[torch.float32]
    ones = torch.ones(z.shape[0], device=device)
    zg = z.detach().clone().requires_grad_()
    torch.testing.assert_close(
        torch.nn.functional.cosine_embedding_loss(z, t, ones, reduction="none"),
        C._plain_forward(z, t), rtol=0, atol=1e-5)
    library = {
        "fwd": lambda: torch.nn.functional.cosine_embedding_loss(
            z, t, ones, reduction="none"),
        "bwd": lambda: torch.autograd.grad(torch.nn.functional.cosine_embedding_loss(
            zg, t, ones, reduction="none"), zg, g),
    }
    lib_times = {part: (time_ms(fn), *device_ms(fn)) for part, fn in library.items()}
    floor = (time_ms(lambda: torch.cuda._sleep(0)), *device_ms(lambda: torch.cuda._sleep(0)))
    for part, (ms, dev, _) in lib_times.items():
        print(f"library (100, 100) f32 {part}: cosine_embedding_loss"
              + (" forward + backward" if part == "bwd" else "")
              + f" per call {ms * 1e3:.2f} us, device time {dev * 1e3:.2f} us  [{card}]")
    print(f"launch floor: empty kernel per call {floor[0] * 1e3:.2f} us, device time "
          f"{floor[1] * 1e3:.2f} us  [{card}]")

    # -- 4. conv kernels against their plain versions -------------------
    phase("4 conv3x3 kernels vs plain (TF32 off)")
    common.set_float32_precision()
    conv_err = {dtype: {} for dtype in (torch.float32, torch.bfloat16)}
    conv_times = {}
    instances = {f"{kernel} {str(dtype)[6:]}": CC.instance(kernel, dtype)
                 for kernel in ("conv3x3_bn_stats", "conv3x3_filter_grad")
                 for dtype in (torch.float32, torch.bfloat16)}
    for key, value in instances.items():
        print(f"instance {key}: {value}")
    check(all("wgmma" in value for value in instances.values()), instances)
    # each wgmma kernel's product on its own against torch.matmul; raises
    # beyond 1e-5 of each entry's sum of |terms|: the bf16 filter gradient's
    # (register A, the MN-major descriptor at whole-row offsets), the bf16
    # conv's (register A, the K-major weight descriptor at each tap's
    # offset, each N it uses), the f32 filter gradient's (3xTF32: register A
    # split in registers, B by swizzled tensor copies split in shared
    # memory), the f32 conv's (3xTF32: register A split in registers, the
    # weight slice split in shared memory and read at each tap's offset)
    wgmma_err = checks.check_wgmma_selftest(torch.Generator(device=device).manual_seed(14))
    print(f"wgmma self-test at (rows, start row) {checks.WGMMA_SELFTEST_CASES}: max |err| "
          f"{wgmma_err:.3g} of the sum of |terms|")
    conv_wgmma_err = checks.check_conv_wgmma_selftest(
        torch.Generator(device=device).manual_seed(15))
    print(f"conv wgmma self-test at N {checks.CONV_WGMMA_N}, taps 0, 4, 8: max |err| "
          f"{conv_wgmma_err:.3g} of the sum of |terms|")
    tf32_err = checks.check_tf32_selftest(torch.Generator(device=device).manual_seed(16))
    print(f"tf32 wgmma self-test at 1-13 slices: max |err| "
          f"{tf32_err:.3g} of the sum of |terms|")
    # the f32 filter gradient's accumulation: products summed in the tensor
    # cores over 8 .. 64 pixels (the kernel's depth: 64) or all 4,096, then
    # f32 adds; its distance from f64 in units of max |d|
    tf32_acc = checks.tf32_accumulation(torch.Generator(device=device).manual_seed(17))
    print("tf32 accumulation over 4,096 pixels, max |err| / max |d| by pixels summed in "
          "the tensor cores: " + ", ".join(f"{k or 'all'} {v:.3g}" for k, v in tf32_acc.items())
          + f"  [{card}]")
    check(tf32_acc[8 * checks.TF32_FLUSH_SLICES] <= checks.DW_OF_MAX / 4, tf32_acc)
    conv_tf32_err = checks.check_conv_tf32_selftest(torch.Generator(device=device).manual_seed(18))
    print(f"conv tf32 wgmma self-test at N {checks.CONV_WGMMA_N}, 1-8 chunks: max |err| "
          f"{conv_tf32_err:.3g} of the sum of |terms|")
    # the f32 conv's accumulation over 4,608 terms: products summed in the
    # tensor cores a chunk at a time (the kernel's 72) or more, or all, then
    # f32 adds; its distance from f64 in units of max |d|, at each N
    conv_tf32_acc = {n: checks.conv_tf32_accumulation(
                         torch.Generator(device=device).manual_seed(19), n)
                     for n in checks.CONV_WGMMA_N}
    for n, errs in conv_tf32_acc.items():
        print(f"conv tf32 accumulation over 4,608 terms at N {n}, max |err| / max |d| by terms "
              "summed in the tensor cores: " + ", ".join(f"{k or 'all'} {v:.3g}"
                                                         for k, v in errs.items()) + f"  [{card}]")
        check(errs[checks.CONV_TF32_CHUNK * checks.CONV_TF32_FLUSH] <= checks.Y_OF_MAX / 4, errs)
    f32 = torch.float32
    for case in checks.CHECK_CASES:
        b, h, w, c, f = case
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            x, wt, dy = checks.conv3x3_check_inputs(case, dtype, gen)
            # raises unless both kernels match the plain versions within
            # checks.CHECK_TOL and the statistics' bounds (stated there)
            errs = checks.check_against_plain(x, wt, dy)
            for key, value in errs.items():
                conv_err[dtype][key] = max(conv_err[dtype].get(key, 0.0), value)
            print(f"{case} {name}: max |err| " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs.items()))
            if case not in checks.STAGE_SHAPES + checks.STAGE_SHAPES_448:
                continue
            flop = 2 * b * h * w * 9 * c * f
            item = x.element_size()
            # each input read once, each output written once: x and w in,
            # y and the two f32 sums out; x and dy in, f32 dw out
            stats_bytes = (x.numel() + wt.numel() + b * f * h * w) * item + 2 * f * 4
            wgrad_bytes = (x.numel() + dy.numel()) * item + wt.numel() * 4
            wshape = tuple(wt.shape)
            print(f"{case} {name}: copy width (elements) filter gradient "
                  f"{CC.filter_grad_copy_width(x, dy)}, conv + statistics "
                  f"{CC.conv_bn_stats_copy_width(x)}")
            calls = {
                "conv3x3_bn_stats": (lambda: CC._launch_conv_bn_stats(x, wt),
                                     lambda: CC._plain_conv_bn_stats(x, wt),
                                     None, stats_bytes),
                # library: cuDNN's wgrad, one PyTorch call of the same function
                "conv3x3_filter_grad": (lambda: CC._launch_filter_grad(x, dy),
                                        lambda: CC._plain_filter_grad(x, dy),
                                        lambda: torch.nn.grad.conv2d_weight(
                                            x, wshape, dy, padding=1),
                                        wgrad_bytes),
            }
            for kernel_name, (kernel, plain, library, nbytes) in calls.items():
                ms, plain_ms = time_ms(kernel, 20, 3), time_ms(plain, 20, 3)
                lib_ms = time_ms(library, 20, 3) if library else None
                (dev, dev_record), (plain_dev, plain_record) = (device_ms(kernel, 5),
                                                                device_ms(plain, 5))
                # f32: the least time for f32-exact products is 3xTF32 on
                # the tensor cores; the f32 FMA units' time stands beside it
                bound_ms, bound_by = bound(flop, nbytes, "3xtf32" if dtype == f32 else name)
                fma_ms = bound(flop, nbytes, "float32")[0] if dtype == f32 else None
                conv_times[kernel_name, case, dtype] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "device_ms": dev, "plain_device_ms": plain_dev,
                    "device_ms_records": {"kernel": dev_record, "plain": plain_record},
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "fma_bound_ms": fma_ms, "share_of_bound": bound_ms / ms,
                    "instance": instances[f"{kernel_name} {name}"]}
                print(f"time {case} {name} {kernel_name}: per call kernel "
                      f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain "
                      f"{plain_ms:.4f} ms, library "
                      + (f"{lib_ms:.4f} ms" if lib_ms else "none")
                      + f"; device time kernel {dev:.4f} ms, plain {plain_dev:.4f} ms; "
                      f"bound {bound_ms:.4f} ms ({bound_by}"
                      + (", 3xTF32 on the tensor cores; f32 FMA "
                         f"{fma_ms:.4f} ms" if fma_ms else "")
                      + f"), kernel at {bound_ms / ms:.3f} of it; device time by kernel "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_record["by_kernel_ms"].items())
                      + f"  [{card}]")
            del x, wt, dy
    torch.cuda.empty_cache()
    # each wrapper's host time a call beside its event and device times, and
    # the hashes of its outputs (for holding two trees' kernels together)
    for (case, dtype), record in conv_records(CC, device).items():
        for kernel_name, r in record.items():
            conv_times[kernel_name, case, dtype].update(r)
            t = conv_times[kernel_name, case, dtype]
            print(f"host {case} {str(dtype)[6:]} {kernel_name}: {r['host_us']:.1f} us a call "
                  f"(event {t['ms'] * 1e3:.1f} us, device {t['device_ms'] * 1e3:.1f} us); "
                  f"sha256 " + ", ".join(f"{k} {v[:16]}" for k, v in r["sha256"].items())
                  + f"  [{card}]")
    # a ResNet-50 step's share of each kernel: launches a step (3 / 4 / 6 / 3
    # bottleneck blocks a stage) times ms a call, summed over the stages,
    # for the kernel, the library call and the bound, at both shape sets
    step_sums = {}
    for kernel_name in ("conv3x3_bn_stats", "conv3x3_filter_grad"):
        for dtype in (f32, torch.bfloat16):
            for size, shapes in (("224", checks.STAGE_SHAPES), ("448", checks.STAGE_SHAPES_448)):
                rows = [conv_times[kernel_name, case, dtype] for case in shapes]
                key = f"{kernel_name} {str(dtype)[6:]} {size}"
                step_sums[key] = {
                    k: None if rows[0][k] is None
                    else sum(n * r[k] for n, r in zip(STAGE_BLOCKS, rows))
                    for k in ("ms", "library_ms", "bound_ms", "device_ms", "host_us")}
                lib = step_sums[key]["library_ms"]
                print(f"step sum {key} (launches {STAGE_BLOCKS}): kernel "
                      f"{step_sums[key]['ms']:.4f} ms (device {step_sums[key]['device_ms']:.4f} "
                      f"ms, host {step_sums[key]['host_us'] / 1e3:.4f} ms), library "
                      + (f"{lib:.4f} ms" if lib is not None else "none")
                      + f", bound {step_sums[key]['bound_ms']:.4f} ms  [{card}]")

    phase("4b 1x1 filter-gradient kernel vs f64, timed beside conv2d_weight (TF32 off); "
          "its launches by path")
    p4b = conv1x1_phase(device, card)
    phase("4c depthwise kernels vs f64 at NASNet-A's 23 shapes, timed beside their bound and "
          "ATen's calls (TF32 off); their launches in a NASNet-A step")
    p4c = depthwise_phase(device, card)

    # -- 5. slice 1 ----------------------------------------------------
    phase("5 slice 1: compute_class_embedding + learn_image_embeddings")
    from semantic_embeddings_torch.cli import learn_image_embeddings

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    hierarchy = os.path.join(tmp, "taxonomy.parent-child.txt")
    emb_path = os.path.join(tmp, "embedding.pickle")
    feat_path = os.path.join(tmp, "feat.pickle")
    model_path = os.path.join(tmp, "model.pt")
    write_taxonomy(hierarchy)
    # the port's compute_class_embedding CLI, in its own process
    sys.stdout.flush()
    subprocess.run([sys.executable, "-m", "semantic_embeddings_torch.cli.compute_class_embedding",
                    "--hierarchy", hierarchy, "--out", emb_path,
                    "--method", "unitsphere"], check=True, cwd=ROOT)
    from semantic_embeddings_torch.embeddings import load_embeddings
    from semantic_embeddings_torch.hierarchy import ClassHierarchy, semantic_distance_matrix

    emb_labels, emb = load_embeddings(emb_path)
    target = 1.0 - semantic_distance_matrix(
        ClassHierarchy.from_file(hierarchy, id_type=int), emb_labels)
    emb_err = np.abs(emb @ emb.T - target).max()
    check(emb_labels == list(range(100)) and emb.shape == (100, 100) and emb_err <= 1e-12,
          (emb.shape, emb_err))
    print(f"class embedding {emb.shape}: max |E E^T - (1 - lcs_height)| {emb_err:.3g}")

    argv = [
        "--dataset", DATASET, "--data_root", tmp, "--embedding", emb_path,
        "--architecture", "resnet-110-wfc", "--loss", "inv_corr",
        "--cls_weight", "0.1", "--fused_loss", "--lr_schedule", "SGDR",
        "--sgdr_max_lr", "0.5", "--batch_size", str(BATCH), "--epochs", "1",
        "--feature_dump", feat_path, "--model_dump", model_path, "--device", "cuda",
    ]
    C.launches_fwd = C.launches_bwd = 0
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = learn_image_embeddings.main(argv)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = {"fwd": C.launches_fwd, "bwd": C.launches_bwd}
    steps = N_TRAIN // BATCH
    print(f"slice ran in {slice_s:.1f} s; train steps {state.step}; "
          f"launches {launches}")
    check(state.step == steps, (state.step, steps))
    check(launches == {"fwd": steps, "bwd": steps}, launches)
    printed = re.findall(r"(\w*loss)['\"]?[=:] ?([^\s,}]+)", tee.buf.getvalue())
    check(len(printed) >= 4, printed)
    for key, value in printed:
        check(math.isfinite(float(value)), (key, value))
    print(f"{len(printed)} printed losses, all finite")
    off_card = [n for n, p in state.model.named_parameters() if p.device.type != "cuda"]
    off_card += [n for n, b in state.model.named_buffers() if b.device.type != "cuda"]
    check(not off_card, off_card)
    with open(feat_path, "rb") as f:
        dump = pickle.load(f)["feat"]  # {test index: feature vector}
    check(sorted(dump) == list(range(N_TEST)), "feature dump indices")
    feats = np.stack([dump[i] for i in range(N_TEST)])
    check(feats.shape == (N_TEST, 100), feats.shape)
    norms = np.linalg.norm(feats.astype(np.float64), axis=1)
    check(np.isfinite(feats).all() and np.abs(norms - 1.0).max() <= 1e-5, norms)
    print(f"feature dump {feats.shape}, max |norm - 1| {np.abs(norms - 1).max():.3g}")

    # -- 5b. stage 3 on slice 1's dumps --------------------------------
    phase("5b stage 3: evaluate_retrieval + evaluate_classification_accuracy")
    collapse = stage3(device, tmp, hierarchy, feat_path, model_path, emb_path, emb, feats)

    # -- 5c. exact top-k and ranking, card vs CPU ----------------------
    phase("5c exact top-k and ranking on the card vs the CPU, bitwise")
    topk_and_ranking_bitwise(device)

    # -- 5d. retrieval throughput --------------------------------------
    phase("5d retrieval throughput, bench_retrieval.py's two protocols")
    taxonomy_1000 = os.path.join(tmp, "taxonomy1000.parent-child.txt")
    write_taxonomy_1000(taxonomy_1000)
    retrieval_rates = {
        "cifar100_test": retrieval_protocol(
            10_000, 100, 100, ClassHierarchy.from_file(hierarchy, id_type=int), True,
            device, card),
        "ilsvrc_val": retrieval_protocol(
            50_000, 1000, 1000, ClassHierarchy.from_file(taxonomy_1000, id_type=int), False,
            device, card),
    }
    torch.cuda.empty_cache()

    # -- 6. one step through the kernels vs the plain versions -----------
    phase("6 one resnet-110-wfc train step: kernel vs plain")
    from semantic_embeddings_torch.data import augment, get_data_generator
    from semantic_embeddings_torch.ops import fused_cosine_loss
    from semantic_embeddings_torch.train import make_train_step

    common.set_float32_precision()
    labels, embedding = common.load_class_embedding(emb_path)
    dataset = get_data_generator(DATASET, classes=labels)
    model, spec = common.build_embedding_model(
        100, "resnet-110-wfc", "inv_corr", 100, seed=1)
    spec.l2_filters = [(r"^cls_top$", 5e-4)] + list(spec.l2_filters)
    state_k = common.init_model_state(model, device)
    state_p = copy.deepcopy(state_k)
    xtr, ytr, _, _ = dataset.device_arrays(device)
    mean = torch.as_tensor(dataset.mean, device=device)
    std = torch.as_tensor(dataset.std, device=device)
    aug = augment.draw_affine_params(
        BATCH, 32, 32, torch.Generator(device=device).manual_seed(5),
        width_shift=0.15, height_shift=0.15, hflip=True)

    def fixed_prepare(raw, rng, train):
        idx = torch.as_tensor(raw["idx"], device=device).long()
        return (augment.affine_apply(xtr[idx].float(), *aug) - mean) / std, ytr[idx]

    kernel_loss = lambda tgt, z: fused_cosine_loss(z, tgt)  # noqa: E731
    plain_loss = lambda tgt, z: C.PlainCosineLoss.apply(z, tgt)  # noqa: E731

    def step_for(state, prepare, loss_fn, autocast_dtype=None):
        """The CLI's --fused_loss train step, with the cosine loss given."""
        return make_train_step(
            state.model.twin("linear", cls_input="l2norm"), prepare,
            loss_name="inv_corr", class_embedding=embedding, num_classes=100,
            cls_weight=0.1, l2_penalty_fn=spec.l2_penalty, clipnorm=10.0,
            loss_fn_override=loss_fn, autocast_dtype=autocast_dtype)

    raw = {"idx": np.arange(BATCH, dtype=np.int32) * 7 % N_TRAIN}
    _, m_k = step_for(state_k, fixed_prepare, kernel_loss)(state_k, raw, 0.5, None)
    _, m_p = step_for(state_p, fixed_prepare, plain_loss)(state_p, raw, 0.5, None)
    torch.cuda.synchronize()
    # One step of the same f32 program; only the cosine loss's kernels
    # differ (a few ulp), and cuDNN may pick another reduction order, so
    # the loss agrees to 1e-5 relative and the updated parameters to 1e-6.
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0.0)
    worst = 0.0
    for (n, a), (_, b) in zip(state_k.model.state_dict().items(),
                              state_p.model.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6, msg=n)
        worst = max(worst, (a - b).abs().max().item())
    print(f"loss kernel {m_k['loss'].item():.7f} plain {m_p['loss'].item():.7f}; "
          f"max |param/stat diff| {worst:.3g}")

    # -- 7. time steady-state train steps -------------------------------
    phase("7 steady-state resnet-110-wfc train steps")
    prepare = dataset.make_prepare(device)
    batches = list(dataset.train_batches(BATCH, 0, 0))[:10]
    rng = torch.Generator(device=device).manual_seed(0)
    rates = {}
    for name, state, loss_fn in (("kernel", state_k, kernel_loss),
                                 ("plain", state_p, plain_loss),
                                 ("kernel", state_k, kernel_loss)):
        step = step_for(state, prepare, loss_fn)
        for raw in batches[:5]:
            step(state, raw, 0.1, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for raw in batches:
            step(state, raw, 0.1, rng)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.setdefault(name, []).append(len(batches) * BATCH / dt)
        print(f"{name} cosine loss: {len(batches)} steps in {dt * 1e3:.1f} ms, "
              f"{len(batches) * BATCH / dt:.1f} img/s (f32, batch {BATCH}) [{card}]")

    if profile_dir:
        phase(f"7b profile of the train step -> {profile_dir}")
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            profile_step(state_k, step_for(state_k, prepare, kernel_loss, dtype),
                         batches, f"{name}, batch {BATCH}, [{card}]",
                         os.path.join(profile_dir, f"train_step_{name}.txt"))
        host_pieces(state_k, step_for(state_k, prepare, kernel_loss), prepare,
                    spec, batches[0], f"f32, batch {BATCH}, [{card}]")

    del state, state_k, state_p, dataset, prepare, batches
    torch.cuda.empty_cache()

    # -- 8. slice 2: ResNet-50 at 224 px --------------------------------
    phase("8 slice 2: resnet-50 @ 224 px, batch 128, f32")
    from semantic_embeddings_torch.cli.common import extract_test_features
    from semantic_embeddings_torch.data import SyntheticDataset
    from semantic_embeddings_torch.models.resnet import use_plain_conv_bn_stats
    from semantic_embeddings_torch.train import (
        fit, get_lr_schedule, make_eval_step, new_train_state)

    def rn50_model(seed=0):
        return rn50_state(device, seed)

    def rn50_step(state, spec, prepare, plain=False, autocast_dtype=None):
        return rn50_train_step(state, spec, prepare, embedding, plain, autocast_dtype)

    reset_counts, read_counts = reset_launches, read_launches

    state, rn_spec = rn50_model()
    rn50_data = SyntheticDataset(num_classes=100, n_train=RN50_TRAIN,
                                 n_test=RN50_TEST, size=rn_spec.input_size,
                                 classes=labels)
    rn_prepare = rn50_data.make_prepare(device, augment_train=False)
    backbone = sum(p.numel() for n, p in state.model.backbone.named_parameters()
                   if not n.startswith("top."))
    print(f"resnet-50: {backbone:,} backbone parameters, "
          f"{sum(p.numel() for p in state.params):,} in all")
    eval_step = make_eval_step(
        state.model, rn_prepare, loss_name="inv_corr", class_embedding=embedding,
        num_classes=100, cls_weight=0.1, l2_penalty_fn=rn_spec.l2_penalty)
    schedule, _ = get_lr_schedule("SGD", RN50_TRAIN, RN50_BATCH)
    tee = _Tee(sys.stdout)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = fit(state, rn50_step(state, rn_spec, rn_prepare), eval_step,
                    rn50_data, schedule, epochs=1, batch_size=RN50_BATCH)
    torch.cuda.synchronize()
    fit_counts = read_counts()
    feats = extract_test_features(state.model, rn50_data, device,
                                  batch_size=RN50_BATCH, pick=0)
    torch.cuda.synchronize()
    rn50_s = time.perf_counter() - t0
    rn50_launches = read_counts()
    steps = RN50_TRAIN // RN50_BATCH
    val_batches = -(-RN50_TEST // RN50_BATCH)
    print(f"slice 2 ran in {rn50_s:.1f} s; train steps {state.step}; launches "
          f"in fit {fit_counts}, with the feature extraction {rn50_launches}")
    check(state.step == steps, (state.step, steps))
    check(fit_counts == {
        "cosine_loss_fwd": steps, "cosine_loss_bwd": steps,
        "conv3x3_bn_stats": RN50_CONVS * (steps + val_batches),
        "conv3x3_filter_grad": RN50_CONVS * steps,
        "conv1x1_filter_grad": RN50_1X1 * steps}, fit_counts)
    check(rn50_launches["conv3x3_bn_stats"]
          == fit_counts["conv3x3_bn_stats"] + RN50_CONVS * val_batches
          and rn50_launches["conv1x1_filter_grad"] == fit_counts["conv1x1_filter_grad"],
          rn50_launches)
    # the f32 steps' filter gradients ran on its TF32 wgmma instance
    fit_instance = CC.instance("conv3x3_filter_grad", torch.float32)
    print(f"the f32 filter gradient's {fit_counts['conv3x3_filter_grad']} launches in fit ran "
          f"{fit_instance}")
    check("wgmma" in fit_instance, fit_instance)
    printed = re.findall(r"(\w*loss)['\"]?[=:] ?([^\s,}]+)", tee.buf.getvalue())
    check(len(printed) >= 4, printed)
    for key, value in printed:
        check(math.isfinite(float(value)), (key, value))
    print(f"{len(printed)} printed losses, all finite")
    off_card = [n for n, p in state.model.named_parameters() if p.device.type != "cuda"]
    off_card += [n for n, b in state.model.named_buffers() if b.device.type != "cuda"]
    check(not off_card, off_card)
    check(feats.shape == (RN50_TEST, 100), feats.shape)
    norms = np.linalg.norm(feats.astype(np.float64), axis=1)
    check(np.isfinite(feats).all() and np.abs(norms - 1.0).max() <= 1e-5, norms)
    print(f"features {feats.shape}, max |norm - 1| {np.abs(norms - 1).max():.3g}")
    # the trained state and the metadata the trainer CLI writes, for 10b
    from semantic_embeddings_torch.train.state import save_checkpoint

    rn50_ckpt = os.path.join(tmp, "resnet50.pt")
    save_checkpoint(rn50_ckpt, state, {"architecture": "resnet-50", "embed_dim": 100,
                                       "loss": "inv_corr", "cls_classes": 100})
    del state, eval_step
    torch.cuda.empty_cache()

    # -- 9. one ResNet-50 step through the kernels vs the plain versions --
    phase("9 one resnet-50 train step: kernel vs plain vs f64 (TF32 off)")
    state_k, rn_spec = rn50_model(seed=1)
    state_p = copy.deepcopy(state_k)
    use_plain_conv_bn_stats(state_p.model)
    state_64 = new_train_state(copy.deepcopy(state_p.model).double())
    before = copy.deepcopy(state_k.model.state_dict())
    raw = next(iter(rn50_data.train_batches(RN50_BATCH, 0, 0)))

    def prepare_64(raw, rng, train):
        images, labels_ = rn_prepare(raw, rng, train)
        return images.double(), labels_

    _, m_k = rn50_step(state_k, rn_spec, rn_prepare)(state_k, raw, 0.1, None)
    _, m_p = rn50_step(state_p, rn_spec, rn_prepare, plain=True)(state_p, raw, 0.1, None)
    _, m_64 = rn50_step(state_64, rn_spec, prepare_64, plain=True)(state_64, raw, 0.1, None)
    torch.cuda.synchronize()
    # The kernel and plain f32 steps differ only in the order of the f32
    # sums inside the 16 conv_b convolutions and filter gradients (and the
    # cosine loss).  The loss agrees to rounding (1e-5 relative).  The
    # updates of the early layers are small sums of large terms of both
    # signs, which amplify any f32 rounding, so they are held to the plain
    # versions' step in f64 (the same program in another precision): tensor
    # by tensor, the kernel step may be no farther from it than twice the
    # plain f32 step's farthest tensor, in units of each tensor's update
    # (BN running statistics: in absolute terms).
    loss_64 = m_64["loss"].item()
    loss_rel = abs(m_k["loss"].item() - m_p["loss"].item()) / abs(m_p["loss"].item())
    print(f"loss kernel {m_k['loss'].item():.9f} plain {m_p['loss'].item():.9f} "
          f"f64 {loss_64:.9f}; kernel vs plain {loss_rel:.3g} relative")
    check(loss_rel <= 1e-5, loss_rel)
    check_against_f64(before, state_64.model, state_k.model, state_p.model)
    # phase 16 takes this step again on two ranks: its state, batch and results
    images_9, labels_9 = rn_prepare(raw, None, True)
    p9_path = os.path.join(tmp, "phase9.pt")
    torch.save({"before": {k: v.cpu() for k, v in before.items()},
                "images": images_9.cpu(), "labels": labels_9.cpu(),
                "kernel": {k: v.cpu() for k, v in state_k.model.state_dict().items()},
                "f64": {k: v.cpu() for k, v in state_64.model.state_dict().items()}}, p9_path)
    del before, state_p, state_64, m_k, m_p, m_64, images_9, labels_9
    torch.cuda.empty_cache()

    # -- 10. ResNet-50 throughput, kernels and plain, f32 and bf16 --------
    phase("10 resnet-50 train-step throughput")
    state_p = copy.deepcopy(state_k)
    use_plain_conv_bn_stats(state_p.model)
    batches = list(rn50_data.train_batches(RN50_BATCH, 0, 0)) * 2  # 8 steps
    rn50_rates = {}
    for precision, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        for path, st in (("kernel", state_k), ("plain", state_p), ("kernel", state_k)):
            label = f"resnet-50 {path} {precision}, batch {RN50_BATCH}, [{card}]"
            table = None  # the profiler's tables of each first run
            if profile_dir and (path, precision) not in rn50_rates:
                table = os.path.join(profile_dir, f"rn50_step_{path}_{precision}.txt")
            result = profile_step(
                st, rn50_step(st, rn_spec, rn_prepare, path == "plain", dtype),
                batches, label, table, n=3, batch=RN50_BATCH)
            rn50_rates.setdefault((path, precision), []).append(result)
    summary = {f"{path}_{precision}": runs for (path, precision), runs in rn50_rates.items()}
    del state_k, state_p, batches
    torch.cuda.empty_cache()

    # -- 10b. serving ResNet-50 @ 224 over HTTP -------------------------
    phase("10b serving resnet-50 @ 224 over HTTP (serve_model.make_server)")
    serving = serve_resnet50(rn50_ckpt, device, card, CC, reset_counts, read_counts)
    torch.cuda.empty_cache()

    # -- 11. no JAX ----------------------------------------------------
    phase("11 no jax, no JAX package")
    import importlib
    import pkgutil

    import semantic_embeddings_torch as port

    modules = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in modules:  # every module of the port, the model zoo's too
        importlib.import_module(name)
    print(f"imported all {len(modules)} modules of the port")
    check("jax" not in sys.modules, "a JAX module was imported")
    tpu = [m for m in sys.modules if m.startswith("semantic_embeddings_tpu")]
    check(not tpu, f"modules of the JAX package were imported: {tpu}")
    print("neither jax nor semantic_embeddings_tpu imported")

    # -- 12. the model zoo ---------------------------------------------
    zoo = model_zoo(device, card, tmp, emb_path, embedding, labels, kernel_loss,
                    plain_loss, reset_counts, read_counts, rn50_data, rn_prepare)
    check("jax" not in sys.modules and not any(
        m.startswith("semantic_embeddings_tpu") for m in sys.modules), "JAX imported")
    zoo_cosine = {arch: r["cosine_launches"] for arch, r in zoo["train"].items()}
    zoo_cosine["nasnet-a (3 fit steps + 1 bf16 step)"] = zoo["nasnet"]["cosine_launches"]

    # -- 13. export, artifact serving, the classifier, --finetune, baselines
    p13 = phase13(device, card, tmp, rn50_ckpt, emb_path, embedding, model_path, CC,
                  reset_counts, read_counts)
    check("jax" not in sys.modules and not any(
        m.startswith("semantic_embeddings_tpu") for m in sys.modules), "JAX imported")
    finetune_launches = {"phase1": p13["finetune"]["phase1"]["launches"],
                         "phase2": p13["finetune"]["phase2_launches"]}

    # -- 14. the file datasets, the CUB recipe at 448 px ----------------
    p14 = phase14(device, card, tmp, CC, C, reset_counts, read_counts)
    check("jax" not in sys.modules and not any(
        m.startswith("semantic_embeddings_tpu") for m in sys.modules), "JAX imported")
    cub_launches = p14["recipe"]["launches"]

    # -- 15. checkpoint interop, the host-side CLIs ----------------------
    p15 = phase15(device, card, tmp, hierarchy, feat_path, model_path, rn50_ckpt,
                  reset_counts, read_counts)
    check("jax" not in sys.modules and not any(
        m.startswith("semantic_embeddings_tpu") for m in sys.modules), "JAX imported")
    interop = {
        # 15b: the eval forward of phase 8's ResNet-50 rebuilt from a JAX model dump
        "launches_jax_checkpoint": p15["jax_checkpoint"]["launches"],
        # 15c: --finetune from a JAX weight dump, by phase
        "launches_finetune_jax": {ph: p15["finetune_jax"][ph] for ph in ("phase1", "phase2")},
        # 15d: the eval forward of the ResNet-50 imported from Keras h5
        "launches_keras_import": p15["keras"]["resnet-50"]["launches"],
    }

    # -- 16. data parallelism on the one card -----------------------------
    p16 = phase16(device, card, tmp, p9_path, embedding, labels, emb_path, rn50_ckpt,
                  taxonomy_1000)
    check("jax" not in sys.modules and not any(
        m.startswith("semantic_embeddings_tpu") for m in sys.modules), "JAX imported")
    data_parallel = {
        # 16a: fit's 3 steps + a validation batch in an NCCL group of one rank
        "fit_3_steps_nccl_world_1": p16["16a"]["launches"]["group"],
        # 16b-c: phase 9's step on each of two gloo ranks (64 rows each)
        "step_each_of_2_ranks_sync_bn": p16["16b"]["launches"],
        "step_each_of_2_ranks_per_replica_bn": p16["16c"]["launches"],
        # 16d: the CLI's --gpus 2 on one card, without and under a launcher
        **{f"cli_gpus_2_{k}": v["launches"] for k, v in p16["16d"].items()},
    }

    # -- 17. spatial partitioning, --profile_dir, pairwise_matrices_device ---
    p17 = phase17(device, card, tmp, embedding, emb_path, CC)
    check("jax" not in sys.modules and not any(
        m.startswith("semantic_embeddings_tpu") for m in sys.modules), "JAX imported")

    f32, bf16 = torch.float32, torch.bfloat16
    kernels = []
    for part, line in (("fwd", 40), ("bwd", 48)):
        kernels.append({
            "name": f"cosine_loss_{part}", "route": "cuda",
            "source": "semantic_embeddings_torch/csrc/cosine_loss.cu",
            "replaces": f"semantic_embeddings_tpu/ops/cosine_loss.py:{line}",
            "launches": launches[part],
            "launches_per_step": 1,
            "launches_resnet50": rn50_launches[f"cosine_loss_{part}"],
            # phase 12: one step of each family in this process, and NASNet-A's
            "launches_zoo": zoo_cosine,
            # phase 13c: --finetune of resnet-50, 4 steps a phase
            "launches_finetune": {ph: c[f"cosine_loss_{part}"]
                                  for ph, c in finetune_launches.items()},
            # phase 14d: the CUB recipe at 448 px, its own process
            "launches_cub_recipe": cub_launches[f"cosine_loss_{part}"],
            **{key: ({ph: c[f"cosine_loss_{part}"] for ph, c in value.items()}
                     if key == "launches_finetune_jax" else value[f"cosine_loss_{part}"])
               for key, value in interop.items()},
            # phase 16: the data-parallel paths
            "launches_data_parallel": {k: v[f"cosine_loss_{part}"]
                                       for k, v in data_parallel.items()},
            # phase 17b: a step of the CUB recipe on each rank of a (1, 2) grid
            "launches_spatial": p17["17b"]["launches"][f"cosine_loss_{part}"],
            "max_abs_err": err[part, f32],
            "max_abs_err_bf16": err[part, bf16],
            "ms": times[part, f32][0], "plain_ms": times[part, f32][1],
            "bound_ms": cos_bound[part, f32][0], "bound_by": cos_bound[part, f32][1],
            "library_ms": lib_times[part][0],
            "library_device_ms": lib_times[part][1],
            "library_call": "torch.nn.functional.cosine_embedding_loss"
                            + (" forward + backward" if part == "bwd" else ""),
            "launch_floor_ms": floor[0], "launch_floor_device_ms": floor[1],
            "device_ms": dev_times[part, f32][0],
            "plain_device_ms": dev_times[part, f32][1],
            # per device_ms reading: the profiler records lost in its two
            # windows, and whether its mean records were rescaled for them
            "device_ms_records": {**dev_records[part, f32],
                                  "library": lib_times[part][2],
                                  "launch_floor": floor[2]},
            "ms_bf16": times[part, bf16][0], "plain_ms_bf16": times[part, bf16][1],
            "bound_ms_bf16": cos_bound[part, bf16][0],
        })
    stage1 = checks.STAGE_SHAPES[0]
    for name, source, replaces, err_key in (
            ("conv3x3_bn_stats", "conv3x3_bn_stats.cu",
             "tools/fused_conv_bn_prototype.py:32", "y"),
            ("conv3x3_filter_grad", "conv3x3_filter_grad.cu",
             "tools/conv_filter_grad_prototype.py:50", "dw")):
        t, t16 = conv_times[name, stage1, f32], conv_times[name, stage1, bf16]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"semantic_embeddings_torch/csrc/{source}",
            "replaces": replaces,
            "launches": rn50_launches[name],
            "launches_per_step": RN50_CONVS,
            # phase 10b: the serving path's launches (16 a device call)
            **({"launches_serving": {run: r["conv3x3_bn_stats_launches"]
                                     for run, r in serving.items()},
                "serving_device_calls": {run: r["device_calls"]
                                         for run, r in serving.items()}}
               if name == "conv3x3_bn_stats" else {}),
            # phase 12d: one ResNet-50 step with --remat and one without
            "launches_remat": {run: zoo["remat"][run]["launches"][name]
                               for run in ("remat", "plain")},
            # phase 13a-b: a call of the exported artifact (batch 1 and 64) and
            # its serving; 13c: the classifier's epoch and --finetune's phases
            **({"launches_export_per_call": {p: r["launches_per_call"]
                                             for p, r in p13["export"].items()},
                "launches_serving_artifact": p13["serving"]["artifact_f32_npy"][
                    "conv3x3_bn_stats_launches"],
                "serving_artifact_device_calls": p13["serving"]["artifact_f32_npy"][
                    "device_calls"]}
               if name == "conv3x3_bn_stats" else {}),
            "launches_classifier": p13["classifier"]["launches"][name],
            "launches_finetune": {ph: c[name] for ph, c in finetune_launches.items()},
            # phase 14d: the CUB recipe at 448 px (batch 24), its own process
            "launches_cub_recipe": cub_launches[name],
            **{key: ({ph: c[name] for ph, c in value.items()}
                     if key == "launches_finetune_jax" else value[name])
               for key, value in interop.items()},
            # phase 16: the data-parallel paths; 16f a serving call on two replicas
            "launches_data_parallel": {
                **{k: v[name] for k, v in data_parallel.items()},
                **({"serving_call_two_replicas": p16["16f"]["conv_launches_per_call"]["two"]}
                   if name == "conv3x3_bn_stats" else {})},
            # phase 17b: a step of the CUB recipe on each rank of a (1, 2)
            # grid, all its launches and those given halo rows; 17a the halo
            # launches at the recipe's shard shapes
            "launches_spatial": p17["17b"]["launches"][name],
            "launches_spatial_halo": p17["17b"]["launches"][f"{name}_halo"],
            "halo_by_shape": {key: {**r[name], "y_vs_whole_bitwise": r["y_vs_whole_bitwise"]}
                              for key, r in p17["17a"].items()},
            "max_abs_err": conv_err[f32][err_key],
            "vs_f64_of_max": conv_err[f32][f"{err_key}_vs_f64_of_max"],
            "plain_vs_f64_of_max": conv_err[f32][f"plain_{err_key}_vs_f64_of_max"],
            "max_abs_err_bf16": conv_err[bf16][err_key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "plain_device_ms": t["plain_device_ms"],
            "device_ms_records": t["device_ms_records"],
            "shape": "stage1 (128, 56, 56, 64, 64) f32",
            "fma_bound_ms": t["fma_bound_ms"],
            "instance": t["instance"], "instance_bf16": t16["instance"],
            "ms_bf16": t16["ms"], "bound_ms_bf16": t16["bound_ms"],
            "library_ms_bf16": t16["library_ms"],
            "by_shape": {f"{case} {str(dtype)[6:]}": conv_times[name, case, dtype]
                         for case in checks.STAGE_SHAPES + checks.STAGE_SHAPES_448
                         for dtype in (f32, bf16)},
            # phase 4: launches x ms a call over a step's stages, per dtype
            # and shape set ("224": batch 128, "448": batch 24)
            "step_sums": {key[len(name) + 1:]: value for key, value in step_sums.items()
                          if key.startswith(name + " ")},
            "wgmma_selftest_of_terms": (wgmma_err if name == "conv3x3_filter_grad"
                                        else conv_wgmma_err),
            # each f32 instance's TF32 wgmma chain on its own, and its
            # accumulation's distance from f64 by terms summed in the tensor
            # cores (0: all; the filter gradient's over 4,096 pixels, the
            # conv's over 4,608 terms at each N)
            **({"tf32_selftest_of_terms": tf32_err, "tf32_accumulation_of_max": tf32_acc}
               if name == "conv3x3_filter_grad" else
               {"tf32_selftest_of_terms": conv_tf32_err,
                "tf32_accumulation_of_max": conv_tf32_acc}),
        })
    print(json.dumps({"kernels": kernels, "card": card,
                      "train_img_per_s_f32": rates, "resnet50_steps": summary,
                      "retrieval": retrieval_rates, "serving": serving,
                      "slice1_feature_spread": collapse, "zoo": zoo, "phase13": p13,
                      "phase14": p14, "phase15": p15, "phase16": p16, "phase17": p17,
                      "conv1x1_filter_grad": p4b, "depthwise_conv": p4c,
                      # the 1x1 filter gradient's launches on the main path's runs
                      "conv1x1_filter_grad_launches": {
                          "fit": fit_counts["conv1x1_filter_grad"],
                          "remat": {run: zoo["remat"][run]["launches"]["conv1x1_filter_grad"]
                                    for run in ("remat", "plain")},
                          "classifier": p13["classifier"]["launches"]["conv1x1_filter_grad"],
                          "finetune": {ph: c["conv1x1_filter_grad"]
                                       for ph, c in finetune_launches.items()},
                          "cub_f32_step": p14["step_vs_f64"]["launches_per_step"][
                              "conv1x1_filter_grad"],
                          "cub_recipe": cub_launches["conv1x1_filter_grad"],
                          "finetune_jax": {ph: p15["finetune_jax"][ph]["conv1x1_filter_grad"]
                                           for ph in ("phase1", "phase2")},
                          "data_parallel": {k: v["conv1x1_filter_grad"]
                                            for k, v in data_parallel.items()},
                          "spatial": p17["17b"]["launches"]["conv1x1_filter_grad"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
