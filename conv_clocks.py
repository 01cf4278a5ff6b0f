#!/usr/bin/env python3
"""Where the cycles of the bf16 conv + statistics kernel go, from clock64()
counters, on one GPU.

    python3 conv_clocks.py

The script copies this checkout's ``conv3x3_bn_stats.cu`` into
``build/clocks/`` with probes: thread 0 of three blocks reads ``clock64()``
between marks placed around each piece of the block's work and adds each
interval to that piece's bucket; the probe blocks then write the buckets and
their total.  The marks are found by exact text, so an edit of the lines
they name makes the script stop and say which text it misses.  It builds
the copy with ``nvcc`` against ``conv3x3_common.cuh``, runs the bf16
instance 5 times at the 56x56x64 and 14x14x256 ResNet-50 stage shapes (batch
128), and prints each probe block's cycles by bucket, with shares, and a call's
time with the probes in.  Thread 0 issues the ``wgmma`` instance's weight
copies, so its view shows their issue; the reads of ``clock64()`` order the
instructions around them, so the buckets are the probed kernel's, not the
unprobed one's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "semantic_embeddings_torch", "csrc", "conv3x3_bn_stats.cu")
PROBE_BLOCKS = (100, 300, 450)

_HEAD = """  const long long clk0 = clock64();
  const int probe = threadIdx.x != 0 ? -1 : blockIdx.x == {0} ? 0 : blockIdx.x == {1} ? 1
                  : blockIdx.x == {2} ? 2 : -1;
  long long ck[12] = {{}};
  long long tp = clk0;
#define MARK(i) {{ const long long tn = clock64(); ck[i] += tn - tp; tp = tn; }}
""".format(*PROBE_BLOCKS)
_TAIL = """  if (probe >= 0) {
    for (int i = 1; i < 12; ++i) conv_clocks[probe][i] = ck[i];
    conv_clocks[probe][0] = clock64() - clk0;
  }
#undef MARK
"""
_READ = """extern "C" {
int read_clocks(unsigned long long* out) {
  const int err = static_cast<int>(cudaMemcpyFromSymbol(out, conv_clocks, sizeof(conv_clocks)));
  static unsigned long long zeros[3][12] = {};
  cudaMemcpyToSymbol(conv_clocks, zeros, sizeof(zeros));
  return err;
}
"""

BUCKETS = ["setup", "barriers", "copy issue", "x wait", "transpose", "weight wait",
           "products", "products' wait", "epilogue: sums", "epilogue: y"]
# (text, the same text with marks): each text must occur once in the source
MARKS = [
    ("  uint16_t* raw = reinterpret_cast", _HEAD + "  uint16_t* raw = reinterpret_cast"),
    ("  load_weight(0);\n", "  MARK(1)\n  load_weight(0);\n"),
    ("  for (int i = 0; i < chunks; ++i) {\n    if (active) mbar_wait(xbar, i & 1);\n",
     "  MARK(3)\n  for (int i = 0; i < chunks; ++i) {\n    if (active) mbar_wait(xbar, i & 1);\n"
     "    MARK(4)\n"),
    ("    __syncthreads();  // x(i) is whole; xt is free; slot (i + 1) % 2's wgmmas are done\n"
     "    if (i + 1 < chunks) load_weight(i + 1);\n    transpose();\n"
     "    __syncthreads();  // xt is whole; raw is free\n"
     "    if (i + 1 < chunks) load_x(i + 1);\n",
     "    __syncthreads();  // x(i) is whole; xt is free; slot (i + 1) % 2's wgmmas are done\n"
     "    MARK(2)\n    if (i + 1 < chunks) load_weight(i + 1);\n    MARK(3)\n    transpose();\n"
     "    MARK(5)\n    __syncthreads();  // xt is whole; raw is free\n    MARK(2)\n"
     "    if (i + 1 < chunks) load_x(i + 1);\n    MARK(3)\n"),
    ("    mbar_wait(&bars[i & 1], (i >> 1) & 1);\n",
     "    mbar_wait(&bars[i & 1], (i >> 1) & 1);\n    MARK(6)\n"),
    ("    wgmma_wait<0>();\n    fence_operands(acc);\n  }\n"
     "  __syncthreads();  // every warp is done with the ring and the transposed windows\n",
     "    MARK(7)\n    wgmma_wait<0>();\n    fence_operands(acc);\n    MARK(8)\n  }\n"
     "  __syncthreads();  // every warp is done with the ring and the transposed windows\n"
     "  MARK(2)\n"),
    ("  if (!active) return;\n", "  MARK(9)\n  if (!active) return;\n"),
    ("    store_y(std::integral_constant<int, 1>{});\n",
     "    store_y(std::integral_constant<int, 1>{});\n  MARK(10)\n" + _TAIL),
]


def probed():
    """The kernel's source with the probes in."""
    text = open(SOURCE).read()
    for old, new in MARKS + [
            ("namespace {\n", "__device__ unsigned long long conv_clocks[3][12];\n\nnamespace {\n"),
            ('extern "C" {\n', _READ)]:
        if text.count(old) != 1:
            raise SystemExit(f"conv_clocks: the source does not hold this text once:\n{old}")
        text = text.replace(old, new)
    return text


def main():
    import torch

    if not torch.cuda.is_available():
        print("conv_clocks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from semantic_embeddings_torch._build import find_nvcc
    from semantic_embeddings_torch.ops import conv3x3 as CC

    out_dir = os.path.join(ROOT, "build", "clocks")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "conv3x3_bn_stats_clocks.cu")
    with open(src, "w") as f:
        f.write(probed())
    lib_path = os.path.join(out_dir, "libconv_clocks.so")
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", os.path.join(ROOT, "semantic_embeddings_torch", "csrc"),
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_bn_stats_partial_rows.argtypes = [i32] * 3
    lib.conv3x3_bn_stats_scratch.argtypes = [ptr] + [i32] * 6
    lib.conv3x3_bn_stats_scratch.restype = ctypes.c_longlong
    lib.conv3x3_bn_stats.argtypes = [ptr] * 9 + [i32] * 6 + [ptr, ptr]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    for case in (CC.STAGE_SHAPES[0], CC.STAGE_SHAPES[2]):
        b, h, w, c, f = case
        x, wt, _ = CC.check_inputs(case, torch.bfloat16,
                                   torch.Generator(device="cuda").manual_seed(0))
        rows = lib.conv3x3_bn_stats_partial_rows(b, h, w)
        y = torch.empty((b, f, h, w), dtype=torch.bfloat16, device="cuda")
        part = torch.empty((2, rows, f), device="cuda")
        sums = torch.empty((2, f), device="cuda")
        scratch = torch.empty(lib.conv3x3_bn_stats_scratch(x.data_ptr(), b, c, h, w, f, 1),
                              dtype=torch.uint8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = lib.conv3x3_bn_stats(
                x.data_ptr(), wt.data_ptr(), None, None, y.data_ptr(), part[0].data_ptr(),
                part[1].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), b, c, h, w, f, 1,
                scratch.data_ptr(), stream)
            if code:
                raise RuntimeError(f"conv_clocks: launch failed, CUDA error {code}")

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        clocks = (ctypes.c_ulonglong * 36)()
        if lib.read_clocks(clocks):
            raise RuntimeError("conv_clocks: could not read the counters")
        for k, block in enumerate(PROBE_BLOCKS):
            counts = list(clocks[12 * k:12 * k + 12])
            if counts[0]:
                print(f"{case} block {block}: {counts[0]} cycles; " + ", ".join(
                    f"{name} {counts[i + 1]} ({counts[i + 1] / counts[0]:.3f})"
                    for i, name in enumerate(BUCKETS)) + f"  [{card}]")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f"{case}: {start.elapsed_time(end) / 20:.4f} ms a call with the probes in  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
