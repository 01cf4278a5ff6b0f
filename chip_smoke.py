#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU, and checks it.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which ends the run with a non-zero exit when it fails:

1. Identify the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions); stop when ``torch.cuda.is_available()`` is false.
2. Build the CUDA kernels from ``semantic_embeddings_torch/csrc/``.
3. Hold each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the training path's shape (100, 100) and at (37, 100),
   (256, 512) and (4, 16) with two all-zero rows; time both at (100, 100).
4. The slice: compute a unitsphere class embedding for a generated
   100-leaf taxonomy (20 superclasses x 5 leaves), then train
   resnet-110-wfc with ``--fused_loss`` for one epoch of
   ``synthetic-100-2000-500`` at batch 100 (20 steps), validate and dump
   test features, through ``learn_image_embeddings.main``.  Checks finite
   losses, one launch of each kernel per train step, every parameter on the
   card, and 500 unit-norm feature rows.
5. One train step through the kernels against one through the plain
   versions, from one copied state and one batch with fixed augmentation.
6. Time 20 steady-state train steps (f32, batch 100).  With
   ``--profile DIR`` also profile the step in f32 and bf16 (device time,
   GPU kernels per step, busy share, peak memory; tables into DIR) and time
   the host's issue of each piece of an f32 step.
7. Check that no JAX module was imported.

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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 100
DATASET = "synthetic-100-2000-500"
N_TRAIN, N_TEST = 2000, 500


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


def phase(name):
    print(f"== {name}", flush=True)


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


def device_ms(fn, iters=50):
    """Device time of one call of ``fn``: the summed duration of the GPU
    kernels it launches, from ``torch.profiler``, without the gaps in which
    the device waits for the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no GPU kernel")
    return sum(e.self_device_time_total for e in kernels) / iters / 1e3


def profile_step(state, step, batches, label, path, n=10):
    """Wall time per train step without the profiler, then ``torch.profiler``
    over ``n`` steps: the device time of the step's GPU kernels, their count,
    the device's busy share (device time / wall time) and the peak device
    memory.  The profiler's tables go to ``path``."""
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
    print(f"profile {label}: wall {wall:.2f} ms/step "
          f"({BATCH / wall * 1e3:.1f} img/s), device {device:.2f} ms/step, "
          f"busy share {device / wall:.3f}, {launches:.0f} GPU kernels/step, "
          f"peak memory {peak:.3f} GiB")


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
    from semantic_embeddings_torch.ops import cosine_loss as C

    # -- 2. build ------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    C._kernels()
    print(f"kernels loaded in {time.perf_counter() - t0:.2f} s")
    for name, (seconds, log) in _build.build_logs.items():
        print(f"built {name} in {seconds:.2f} s\n{log.strip()}")

    # -- 3. kernels against their plain versions ----------------------
    phase("3 kernels vs plain")
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
    times, dev_times = {}, {}
    for dtype, (z, t, g) in path_inputs.items():
        name = str(dtype)[6:]
        calls = {
            "fwd": (lambda: C._launch_forward(z, t), lambda: C._plain_forward(z, t)),
            "bwd": (lambda: C._launch_backward(z, t, g),
                    lambda: C._plain_backward(z, t, g)),
            "fwd+bwd": (lambda: (C._launch_forward(z, t), C._launch_backward(z, t, g)),
                        lambda: (C._plain_forward(z, t), C._plain_backward(z, t, g))),
        }
        for part, (kernel, plain) in calls.items():
            times[part, dtype] = (time_ms(kernel), time_ms(plain))
            dev_times[part, dtype] = (device_ms(kernel), device_ms(plain))
            (k, p), (kd, pd) = times[part, dtype], dev_times[part, dtype]
            print(f"time (100, 100) {name} {part}: per call kernel {k * 1e3:.2f} us, "
                  f"plain {p * 1e3:.2f} us; device time kernel {kd * 1e3:.2f} us, "
                  f"plain {pd * 1e3:.2f} us  [{card}]")

    # -- 4. the slice --------------------------------------------------
    phase("4 slice: compute_class_embedding + learn_image_embeddings")
    from semantic_embeddings_torch.cli import learn_image_embeddings

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    hierarchy = os.path.join(tmp, "taxonomy.parent-child.txt")
    emb_path = os.path.join(tmp, "embedding.pickle")
    feat_path = os.path.join(tmp, "feat.pickle")
    write_taxonomy(hierarchy)
    # the repo's numpy-only compute_class_embedding.py, in its own process
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.join(ROOT, "compute_class_embedding.py"),
                    "--hierarchy", hierarchy, "--out", emb_path,
                    "--method", "unitsphere"], check=True)

    argv = [
        "--dataset", DATASET, "--data_root", tmp, "--embedding", emb_path,
        "--architecture", "resnet-110-wfc", "--loss", "inv_corr",
        "--cls_weight", "0.1", "--fused_loss", "--lr_schedule", "SGDR",
        "--sgdr_max_lr", "0.5", "--batch_size", str(BATCH), "--epochs", "1",
        "--feature_dump", feat_path, "--device", "cuda",
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

    # -- 5. one step through the kernels vs the plain versions -----------
    phase("5 one train step: kernel vs plain")
    from semantic_embeddings_torch.cli import common
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

    # -- 6. time steady-state train steps -------------------------------
    phase("6 steady-state train steps")
    prepare = dataset.make_prepare(device)
    batches = list(dataset.train_batches(BATCH, 0, 0))
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
        phase(f"6b profile of the train step -> {profile_dir}")
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            profile_step(state_k, step_for(state_k, prepare, kernel_loss, dtype),
                         batches, f"{name}, batch {BATCH}, [{card}]",
                         os.path.join(profile_dir, f"train_step_{name}.txt"))
        host_pieces(state_k, step_for(state_k, prepare, kernel_loss), prepare,
                    spec, batches[0], f"f32, batch {BATCH}, [{card}]")

    # -- 7. no JAX -----------------------------------------------------
    phase("7 no jax")
    check("jax" not in sys.modules, "a JAX module was imported")
    print("jax not imported")

    kernels = []
    for part, line in (("fwd", 40), ("bwd", 48)):
        f32, bf16 = torch.float32, torch.bfloat16
        kernels.append({
            "name": f"cosine_loss_{part}", "route": "cuda",
            "source": "semantic_embeddings_torch/csrc/cosine_loss.cu",
            "replaces": f"semantic_embeddings_tpu/ops/cosine_loss.py:{line}",
            "launches": launches[part],
            "max_abs_err": err[part, f32],
            "max_abs_err_bf16": err[part, bf16],
            "ms": times[part, f32][0], "plain_ms": times[part, f32][1],
            "device_ms": dev_times[part, f32][0],
            "plain_device_ms": dev_times[part, f32][1],
            "ms_bf16": times[part, bf16][0], "plain_ms_bf16": times[part, bf16][1],
        })
    print(json.dumps({"kernels": kernels, "card": card,
                      "train_img_per_s_f32": rates}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
