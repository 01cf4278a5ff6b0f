#!/usr/bin/env python3
"""Where the cycles of the 3x3 conv kernels go, from clock64() counters, on
one GPU.

    python3 conv_clocks.py

The kernels' own sources hold the probes: ``CLOCK_MARK(i)`` in
``csrc/conv3x3_bn_stats.cu`` and ``csrc/conv3x3_filter_grad.cu``, which
compile to nothing unless ``CONV3X3_CLOCKS`` is defined
(``csrc/conv3x3_common.cuh``; the build of ``_build.py`` never defines it).
This script builds both sources with ``nvcc -DCONV3X3_CLOCKS`` (and
``_build.NVCC_FLAGS``) into ``build/clocks/``, runs each probed instance 5
times at the 56x56x64 and 14x14x256 ResNet-50 stage shapes (batch 128,
through the port's own wrappers), and prints, for thread 0 of three blocks
(at 1/8, 1/2 and 7/8 of the grid), its cycles by bucket with shares, and a
call's time with the probes in.  Instances: the conv + statistics and the
filter gradient, each in bf16 and f32.  The reads of ``clock64()`` order the
instructions around them, so the buckets are the probed build's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# bucket i: the cycles between a CLOCK_MARK and the CLOCK_MARK(i) after it
CONV_BUCKETS = {1: "setup", 2: "barriers", 3: "copy issue", 4: "x wait", 5: "transpose / halo rows",
                6: "weight wait", 7: "products", 8: "products' wait", 9: "epilogue: sums",
                10: "epilogue: y"}
GRAD_BUCKETS = {1: "setup", 2: "copy wait (bf16: + barriers)", 3: "copy issue",
                4: "split / transpose", 5: "A fragments", 6: "products", 7: "products' wait",
                8: "sums", 9: "epilogue", 10: "barriers (f32)"}


def build(name):
    """``csrc/<name>.cu`` with the probes compiled in, loaded."""
    from semantic_embeddings_torch import _build

    out_dir = os.path.join(ROOT, "build", "clocks")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{name}_clocks.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DCONV3X3_CLOCKS", "-o",
                           lib_path, str(_build.CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"conv_clocks: nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.conv3x3_clocks_read.argtypes = [ctypes.c_void_p]
    return lib


def main():
    import torch

    if not torch.cuda.is_available():
        print("conv_clocks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from semantic_embeddings_torch.ops import checks
    from semantic_embeddings_torch.ops import conv3x3 as CC

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    fwd, wgrad = build("conv3x3_bn_stats"), build("conv3x3_filter_grad")
    CC._libs = CC.declare(fwd, wgrad)  # the wrappers now launch the probed builds
    runs = [("conv3x3_bn_stats", torch.bfloat16, fwd, CONV_BUCKETS),
            ("conv3x3_bn_stats", torch.float32, fwd, CONV_BUCKETS),
            ("conv3x3_filter_grad", torch.bfloat16, wgrad, GRAD_BUCKETS),
            ("conv3x3_filter_grad", torch.float32, wgrad, GRAD_BUCKETS)]
    for case in (checks.STAGE_SHAPES[0], checks.STAGE_SHAPES[2]):
        for kernel, dtype, lib, buckets in runs:
            x, wt, dy = checks.conv3x3_check_inputs(case, dtype,
                                                    torch.Generator(device="cuda").manual_seed(0))
            if kernel == "conv3x3_bn_stats":
                def call():
                    return CC._launch_conv_bn_stats(x, wt)
            else:
                def call():
                    return CC._launch_filter_grad(x, dy)
            clocks = (ctypes.c_ulonglong * 48)()
            lib.conv3x3_clocks_read(clocks)  # clears what earlier launches left
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            if lib.conv3x3_clocks_read(clocks):
                raise RuntimeError("conv_clocks: could not read the counters")
            label = f"{kernel} {str(dtype)[6:]} {case}"
            for k, where in enumerate(("1/8", "1/2", "7/8")):
                counts = list(clocks[16 * k:16 * k + 16])
                if counts[0]:
                    print(f"{label} block at {where} of the grid: {counts[0]} cycles; " + ", ".join(
                        f"{name} {counts[i]} ({counts[i] / counts[0]:.3f})"
                        for i, name in buckets.items()) + f"  [{card}]")
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            print(f"{label}: {start.elapsed_time(end) / 20:.4f} ms a call with the probes in"
                  f"  [{card}]")
            del x, wt, dy
    return 0


if __name__ == "__main__":
    sys.exit(main())
