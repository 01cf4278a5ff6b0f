"""Holding the port's hand-written kernels against their plain versions and
f64, on the card: the shapes each is checked at, its inputs and tolerances,
the checks, and the ``wgmma`` self-tests that run one product of a kernel on
its own.  The program never imports this module: the tests,
``chip_smoke.py`` and ``conv_clocks.py`` do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import conv1x1, conv3x3, depthwise


# ---------------------------------------------------------------------------
# conv3x3: the ``wgmma`` self-tests
# ---------------------------------------------------------------------------

#: pixel rows of x a channel that the bf16 filter gradient stages a step (its
#: transposed B operand), the most rows :func:`wgmma_selftest` takes
WGMMA_B_ROWS = 240


def wgmma_selftest(a, b, row):
    """One ``wgmma`` of the bf16 filter-gradient instance on its own: the
    f32 (64, 32) product of ``a`` (64, 16) and ``b[row:row + 16]`` for
    contiguous bf16 CUDA tensors ``a`` and ``b`` (rows, 32), rows <=
    :data:`WGMMA_B_ROWS`.  ``a`` goes into registers as the kernel
    loads dy, ``b`` into the kernel's transposed layout of x, read through
    its matrix descriptor started ``row`` pixel rows in.  Synchronizes."""
    if (a.shape != (64, 16) or b.ndim != 2 or b.shape[1] != 32
            or not 16 <= b.shape[0] <= WGMMA_B_ROWS or not 0 <= row <= b.shape[0] - 16):
        raise ValueError(f"wgmma self-test takes a (64, 16) and b (16..240, 32) with "
                         f"row + 16 <= rows; got {tuple(a.shape)}, {tuple(b.shape)}, {row}")
    conv3x3._check(a[None, None], b[None, None], "wgmma self-test")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"wgmma self-test takes bf16 operands, not {a.dtype}")
    d = torch.empty((64, 32), dtype=torch.float32, device=a.device)
    code = conv3x3._kernels()[1].conv3x3_filter_grad_wgmma_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), b.shape[0], row,
        torch.cuda.current_stream(a.device).cuda_stream)
    conv3x3._raise_on(code, "wgmma self-test")
    torch.cuda.synchronize(a.device)
    return d


def tf32_selftest(a, b, depth):
    """A chain of the f32 filter-gradient instance's TF32 ``wgmma`` on its
    own: the f32 (64, 64) product ``a @ b.T`` of contiguous f32 CUDA
    tensors ``a`` and ``b`` (64, K), K a multiple of 8: ``a``
    split into big and small TF32 parts in registers, ``b`` landed by
    tensor copies with the 128-byte swizzle and split in shared memory,
    three ``wgmma`` a k8 slice (3xTF32); the products of ``depth``
    consecutive slices summed in the tensor cores from zero, then added to
    the running sums in f32 (0: all of K in the tensor cores).
    Synchronizes."""
    if (a.ndim != 2 or b.ndim != 2 or a.shape[0] != 64 or b.shape[0] != 64
            or a.shape[1] != b.shape[1] or a.shape[1] % 8 or a.shape[1] < 8 or depth < 0):
        raise ValueError(f"tf32 self-test takes a and b (64, K), K a multiple of 8, and a "
                         f"depth >= 0; got {tuple(a.shape)}, {tuple(b.shape)}, {depth}")
    conv3x3._check(a[None, None], b[None, None], "tf32 self-test")
    if a.dtype != torch.float32:
        raise TypeError(f"tf32 self-test takes f32 operands, not {a.dtype}")
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    code = conv3x3._kernels()[1].conv3x3_filter_grad_tf32_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), 64, a.shape[1] // 8, depth,
        torch.cuda.current_stream(a.device).cuda_stream)
    conv3x3._raise_on(code, "tf32 self-test")
    torch.cuda.synchronize(a.device)
    return d


#: slices of 8 pixels whose products the f32 filter gradient sums in the
#: tensor cores before one f32 add to its running sums: a pipeline step
TF32_FLUSH_SLICES = 8


def check_tf32_selftest(generator):
    """Runs :func:`tf32_selftest` at 1, 3, 8 and 13 slices (the chain
    crossing the 64-pixel copies), with the
    kernel's :data:`TF32_FLUSH_SLICES`, on N(0, 1) f32 values drawn from
    the CUDA ``generator``, and asserts that every entry of d equals
    ``torch.matmul`` of the same values in f64 within 1e-5 of its sum of
    |terms|: 3xTF32 products are f32-exact to about 2**-20 relative, one
    TF32 product only to 2**-11.  Returns the largest error in those
    units."""
    device = generator.device
    worst = 0.0
    for slices in (1, 3, 8, 13):
        a = torch.randn((64, 8 * slices), generator=generator, device=device)
        b = torch.randn((64, 8 * slices), generator=generator, device=device)
        d = tf32_selftest(a, b, TF32_FLUSH_SLICES)
        ref = torch.matmul(a.double(), b.double().T)
        scale = torch.matmul(a.double().abs(), b.double().abs().T).clamp_min(1e-30)
        err = ((d.double() - ref).abs() / scale).max().item()
        if not err <= 1e-5:
            raise AssertionError(f"tf32 self-test at {slices} slices: d differs from "
                                 f"torch.matmul by {err:.3g} of the sum of |terms|")
        worst = max(worst, err)
    return worst


def tf32_accumulation(generator, pixels=4096, depths=(1, 2, 4, 8, 0)):
    """How far the f32 filter gradient's accumulation lands from f64: for
    each depth in slices of 8 pixels (0: all of them), ``tf32_selftest`` of
    N(0, 1) f32 values, a (64, ``pixels``) and b (64, ``pixels``) from the
    CUDA ``generator`` (a block's share of a split is a few thousand
    pixels), its max |d - f64| over the max |f64|.  Returns
    ``{pixels summed in the tensor cores (0: all): that error}``."""
    device = generator.device
    a = torch.randn((64, pixels), generator=generator, device=device)
    b = torch.randn((64, pixels), generator=generator, device=device)
    ref = torch.matmul(a.double(), b.double().T)
    scale = ref.abs().max().item()
    return {8 * depth: (tf32_selftest(a, b, depth).double() - ref).abs().max().item() / scale
            for depth in depths}


#: the wgmma widths N (output channels a warpgroup) of both instances of the
#: conv + statistics kernel: 64 where F <= 64, else 128
CONV_WGMMA_N = (64, 128)


def conv_wgmma_selftest(a, b, tap):
    """One ``wgmma`` of the bf16 conv + statistics instance on its own: the
    f32 (64, N) product of ``a`` (64, 16) and ``b[tap]`` transposed, for
    contiguous bf16 CUDA tensors ``a`` and ``b`` (9, N, 16), N in
    :data:`CONV_WGMMA_N`.  ``a`` goes into registers as the kernel loads x's
    transposed windows (``ldmatrix``), ``b`` into the kernel's weight slice
    (K-major core matrices), read through its descriptor started at the
    tap's offset.  Synchronizes."""
    if (a.shape != (64, 16) or b.ndim != 3 or b.shape[0] != 9 or b.shape[2] != 16
            or b.shape[1] not in CONV_WGMMA_N or not 0 <= tap < 9):
        raise ValueError(f"conv wgmma self-test takes a (64, 16), b (9, N, 16) with N in "
                         f"{CONV_WGMMA_N} and a tap in 0..8; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tap}")
    conv3x3._check(a[None, None], b[None], "conv wgmma self-test")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"conv wgmma self-test takes bf16 operands, not {a.dtype}")
    n = b.shape[1]
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    code = conv3x3._kernels()[0].conv3x3_bn_stats_wgmma_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), n, tap,
        torch.cuda.current_stream(a.device).cuda_stream)
    conv3x3._raise_on(code, "conv wgmma self-test")
    torch.cuda.synchronize(a.device)
    return d


#: K values of one chunk of the f32 conv + statistics kernel: 8 channels x 9
#: taps, one k8 slice a tap; its products are summed in the tensor cores
#: from zero, then added to the running sums in f32 (:data:`CONV_TF32_FLUSH`
#: chunks at a time)
CONV_TF32_CHUNK = 72
CONV_TF32_FLUSH = 1


def conv_tf32_selftest(a, b, flush):
    """The f32 conv + statistics instance's TF32 ``wgmma`` chain on its own:
    the f32 (64, N) product ``a @ b.T`` of contiguous f32 CUDA tensors ``a``
    (64, K) and ``b`` (N, K), N in :data:`CONV_WGMMA_N` and K a multiple of
    :data:`CONV_TF32_CHUNK`, in the kernel's K order (chunk, tap, channel):
    ``a`` split into big and small TF32 parts in registers as the kernel
    loads x, ``b`` written into the weight slice's layout and split in
    shared memory, three ``wgmma`` a tap through the descriptors started at
    the tap's offset (3xTF32); the products of ``flush`` consecutive chunks
    summed in the tensor cores from zero, then added to the running sums in
    f32 (0: all of K in the tensor cores).  Synchronizes."""
    if (a.ndim != 2 or b.ndim != 2 or a.shape[0] != 64 or b.shape[0] not in CONV_WGMMA_N
            or a.shape[1] != b.shape[1] or a.shape[1] % CONV_TF32_CHUNK or a.shape[1] < 1
            or flush < 0):
        raise ValueError(f"conv tf32 self-test takes a (64, K) and b (N, K), N in "
                         f"{CONV_WGMMA_N}, K a multiple of {CONV_TF32_CHUNK}, and a flush "
                         f">= 0; got {tuple(a.shape)}, {tuple(b.shape)}, {flush}")
    conv3x3._check(a[None, None], b[None, None], "conv tf32 self-test")
    if a.dtype != torch.float32:
        raise TypeError(f"conv tf32 self-test takes f32 operands, not {a.dtype}")
    n = b.shape[0]
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    code = conv3x3._kernels()[0].conv3x3_bn_stats_tf32_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), n, a.shape[1] // CONV_TF32_CHUNK, flush,
        torch.cuda.current_stream(a.device).cuda_stream)
    conv3x3._raise_on(code, "conv tf32 self-test")
    torch.cuda.synchronize(a.device)
    return d


def check_conv_tf32_selftest(generator):
    """Runs :func:`conv_tf32_selftest` at each N of :data:`CONV_WGMMA_N` over
    1, 3 and 8 chunks with the kernel's :data:`CONV_TF32_FLUSH`, on N(0, 1)
    f32 values drawn from the CUDA ``generator``, and asserts that every
    entry of d equals ``torch.matmul`` of the same values in f64 within 1e-5
    of its sum of |terms|: 3xTF32 products are f32-exact to about 2**-20
    relative, one TF32 product only to 2**-11.  Returns the largest error
    in those units."""
    device = generator.device
    worst = 0.0
    for n in CONV_WGMMA_N:
        for chunks in (1, 3, 8):
            k = chunks * CONV_TF32_CHUNK
            a = torch.randn((64, k), generator=generator, device=device)
            b = torch.randn((n, k), generator=generator, device=device)
            d = conv_tf32_selftest(a, b, CONV_TF32_FLUSH)
            ref = torch.matmul(a.double(), b.double().T)
            scale = torch.matmul(a.double().abs(), b.double().abs().T).clamp_min(1e-30)
            err = ((d.double() - ref).abs() / scale).max().item()
            if not err <= 1e-5:
                raise AssertionError(f"conv tf32 self-test at N {n}, {chunks} chunks: d differs "
                                     f"from torch.matmul by {err:.3g} of the sum of |terms|")
            worst = max(worst, err)
    return worst


def conv_tf32_accumulation(generator, n, chunks=64, flushes=(1, 2, 4, 0)):
    """How far the f32 conv's accumulation lands from f64 at wgmma width
    ``n``: for each flush in chunks of :data:`CONV_TF32_CHUNK` terms (0: all
    of them in the tensor cores), :func:`conv_tf32_selftest` of N(0, 1) f32
    values a (64, K) and b (n, K), K = ``chunks`` x 72 (64 chunks: a y of
    the 512-channel stage), from the CUDA ``generator``; its max |d - f64|
    over the max |f64|.  Returns ``{terms summed in the tensor cores (0:
    all): that error}``."""
    device = generator.device
    k = chunks * CONV_TF32_CHUNK
    a = torch.randn((64, k), generator=generator, device=device)
    b = torch.randn((n, k), generator=generator, device=device)
    ref = torch.matmul(a.double(), b.double().T)
    scale = ref.abs().max().item()
    return {CONV_TF32_CHUNK * flush: (conv_tf32_selftest(a, b, flush).double() - ref).abs().max()
            .item() / scale for flush in flushes}


# ---------------------------------------------------------------------------
# conv3x3: the kernels against the plain versions
# ---------------------------------------------------------------------------

#: (B, H, W, C, F) at which the kernels are checked: the mid 3x3 conv of
#: each ResNet-50 stage at 224 px, batch 128 (tools/bench_fused_conv.py),
#: then ragged shapes (nothing a multiple of a tile; F and 9C past one tile)
STAGE_SHAPES = [(128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
                (128, 14, 14, 256, 256), (128, 7, 7, 512, 512)]
#: shapes whose planes (H*W) take each copy path of the bf16 kernels: 8
#: elements (16 bytes), then the repack into padded planes (1) for H*W % 8
#: == 4 and for H*W = 49
ALIGN_CASES = [(4, 8, 8, 24, 80), (4, 14, 14, 32, 64), (4, 7, 7, 40, 72)]
#: the mid 3x3 conv of each ResNet-50 stage at 448 px, batch 24 (the
#: CosineLoss.md CUB recipe): planes of 12,544 to 196 pixels, N*H*W up to
#: 301,056 for the filter gradient's split
STAGE_SHAPES_448 = [(24, 112, 112, 64, 64), (24, 56, 56, 128, 128),
                    (24, 28, 28, 256, 256), (24, 14, 14, 512, 512)]
CHECK_CASES = STAGE_SHAPES + [(3, 7, 7, 5, 10), (2, 13, 9, 16, 24),
                              (1, 5, 3, 70, 130), (3, 5, 10, 16, 40)] + ALIGN_CASES \
    + STAGE_SHAPES_448

#: Tolerances of each kernel's result against its plain version on the same
#: inputs (conv3x3_check_inputs: x and dy of N(0, 1), He-scaled w, so y is O(1)).
#: f32 y: each y sums 9C <= 4608 products.  The kernel takes each as 3xTF32
#: (f32-exact to about 2**-20 relative), sums the 72 products of one chunk
#: (8 channels x 9 taps) in the tensor cores from zero and adds the C / 8
#: such sums with rounded f32 adds, whose errors, adding as a random walk,
#: stay near 1e-7 of max |y| (summed over all 9C in the tensor cores they
#: would land 3.2-3.5e-5 away, :func:`conv_tf32_accumulation`); it is held
#: to an f64 conv of the same inputs within Y_OF_MAX of max |y| (one TF32
#: product, 2**-11 relative, would miss that).  cuDNN may take a Winograd or FFT algorithm, whose f32 error
#: is about 1e-5 of the output's scale (on an H100 an in-order f32 sum and
#: cuDNN's differed by 1.3-1.7e-5 at the ResNet-50 stage shapes): its
#: distance from f64 is reported beside the kernel's, and y is held to it
#: within CHECK_TOL.  bf16 y: both round f32 sums that agree
#: to about 1e-5, so they differ by at most one bf16 ulp (2**-7 relative)
#: where the sums straddle a rounding boundary (the tensor-core kernel
#: measured one ulp, 0.0156 at |y| in [2, 4), at every stage shape).  dw is
#: held to an f64 reference computed from the same inputs: it sums N*H*W <=
#: 401,408 products, each block of the kernel at most a few thousand of them
#: and the splits in order, whose rounding errors, adding as a random walk,
#: stay near 1e-6 of max |dw|; 1e-5 of it is the bound.  Measured on an
#: H100 at the stage shapes: the f32 instance (3xTF32 on TF32 wgmma, each
#: tap's products of a 64-pixel step summed from zero in the tensor cores
#: and added to the running sums with one rounded f32 add; summed over a
#: whole split in the tensor cores they would land 1.4-3.2e-5 away,
#: :func:`tf32_accumulation`) 5.0-7.0e-7 of max |dw|; the bf16 instance
#: (exact products, f32 accumulation in the tensor cores, on wgmma)
#: 2.2-4.2e-6.
#: Against the plain version, dw may differ by the plain version's own
#: distance from f64 (cuDNN's f32 algorithm, or the rounding of dw to bf16)
#: plus that bound.  The statistics are held to bounds derived from the
#: measured y difference in :func:`check_against_plain`.
CHECK_TOL = {
    torch.float32: dict(y=dict(rtol=1e-4, atol=1e-4)),
    torch.bfloat16: dict(y=dict(rtol=2**-7, atol=1e-3)),
}
DW_OF_MAX = 1e-5
Y_OF_MAX = 1e-5


def conv3x3_check_inputs(case, dtype, generator):
    """``(x, w, dy)`` on ``generator``'s device in ``dtype``: x (B, C, H, W)
    and dy (B, F, H, W) of N(0, 1), w (F, C, 3, 3) of N(0, 2 / 9C)."""
    b, h, wd, c, f = case
    device = generator.device

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    return (normal(b, c, h, wd), normal(f, c, 3, 3, std=math.sqrt(2.0 / (9 * c))),
            normal(b, f, h, wd))


def _sum_depth(rows):
    """The most additions any y term passes through in the kernel's sums,
    the same tree in both instances (``wgmma``, pixels as M): a thread's two
    rows of a column (1 addition), the 8 lanes of a column (3 levels), the
    warpgroup's 4 warps in order (3); then ceil(rows / 32) per phase and 32
    phases in the second pass."""
    return 1 + 3 + 3 + -(-rows // 32) + 32


def check_against_plain(x, w, dy):
    """Launches both kernels on CUDA tensors, synchronizing after each, and
    asserts their results equal the plain versions' within
    :data:`CHECK_TOL` (dw: :data:`DW_OF_MAX`, against an f64 reference; f32
    y also within :data:`Y_OF_MAX` of an f64 conv); returns the max |error|
    against the plain version of y, of s / n and ss / n (the mean and mean
    square BN reads) and of dw, and the distance of the kernel's and the
    plain version's y and dw from f64, in units of max |y| and max |dw|."""
    y, s, ss = conv3x3._launch_conv_bn_stats(x, w)
    torch.cuda.synchronize()
    dw = conv3x3._launch_filter_grad(x, dy)
    torch.cuda.synchronize()
    if y.dtype != x.dtype or dw.dtype != torch.float32:
        raise AssertionError(f"y is {y.dtype}, dw {dw.dtype} for {x.dtype} x")
    y_p, s_p, ss_p = conv3x3._plain_conv_bn_stats(x, w)
    dw_p = conv3x3._plain_filter_grad(x, dy)
    tol = CHECK_TOL[x.dtype]
    torch.testing.assert_close(y.float(), y_p.float(), **tol["y"])
    y_f64 = F.conv2d(x.double(), w.double(), padding=1)
    y_scale = y_f64.abs().max().item()
    y_of_max = (y.double() - y_f64).abs().max().item() / y_scale
    if x.dtype == torch.float32 and y_of_max > Y_OF_MAX:
        raise AssertionError(f"kernel y differs from f64 by {y_of_max:.3g} of max |y| "
                             f"(bound {Y_OF_MAX:.3g})")

    # The statistics: against f64 sums of the kernel's own y, within the f32
    # rounding bound of its summation tree (depth * 2**-24 of sum |terms|);
    # against f64 sums of the plain version's y, within that bound plus the
    # difference of the two y's (|sum a - sum b| <= sum |a - b|).
    y64, yp64 = y.double(), y_p.double()
    n = y.numel() // y.shape[1]
    rows = conv3x3._kernels()[0].conv3x3_bn_stats_partial_rows(x.shape[0], x.shape[2], x.shape[3])
    u = _sum_depth(rows) * 2.0**-24
    dims = (0, 2, 3)
    for got, terms, terms_p in ((s, y64, yp64), (ss, y64 * y64, yp64 * yp64)):
        err = (got.double() - terms.sum(dims)).abs()
        bound = u * terms.abs().sum(dims)
        if (err > bound).any():
            raise AssertionError(
                f"kernel statistics differ from f64 sums of its y by "
                f"{err.max().item():.3g} (bound {bound.min().item():.3g})")
        if ((got.double() - terms_p.sum(dims)).abs()
                > bound + (terms - terms_p).abs().sum(dims)).any():
            raise AssertionError("kernel statistics differ from the plain version's")

    dw64 = conv3x3._plain_filter_grad(x.double(), dy.double())
    bound = DW_OF_MAX * dw64.abs().max().item()
    err64 = (dw.double() - dw64).abs()
    if (err64 > bound).any():
        raise AssertionError(f"kernel dw differs from f64 by {err64.max().item():.3g} "
                             f"(bound {bound:.3g})")
    err_p = (dw - dw_p).double().abs()
    if (err_p > (dw_p.double() - dw64).abs() + bound).any():
        raise AssertionError(f"kernel dw differs from the plain version's by "
                             f"{err_p.max().item():.3g}")
    return {
        "y": (y.float() - y_p.float()).abs().max().item(),
        "mean": ((s - s_p).abs().max() / n).item(),
        "mean_square": ((ss - ss_p).abs().max() / n).item(),
        "y_vs_f64_of_max": y_of_max,
        "plain_y_vs_f64_of_max": (y_p.double() - y_f64).abs().max().item() / y_scale,
        "dw": err_p.max().item(),
        "dw_vs_f64_of_max": err64.max().item() / dw64.abs().max().item(),
        "plain_dw_vs_f64_of_max": ((dw_p.double() - dw64).abs().max()
                                   / dw64.abs().max()).item(),
    }


#: (rows of b, start row) at which :func:`check_wgmma_selftest` runs the
#: wgmma on its own: all rows from the first, from an odd row, from the
#: last start, and a shorter b
WGMMA_SELFTEST_CASES = [(WGMMA_B_ROWS, 0), (WGMMA_B_ROWS, 5),
                        (WGMMA_B_ROWS, WGMMA_B_ROWS - 16), (40, 17)]


def check_conv_wgmma_selftest(generator):
    """Runs :func:`conv_wgmma_selftest` at each N of :data:`CONV_WGMMA_N`
    and taps 0, 4 and 8 on N(0, 1) bf16 values drawn from the CUDA
    ``generator`` and asserts that every entry of d equals ``torch.matmul``
    of the same values in f64 within 1e-5 of its sum of |terms| (16 exact
    products summed in f32).  Returns the largest error in those units."""
    device = generator.device
    worst = 0.0
    for n in CONV_WGMMA_N:
        for tap in (0, 4, 8):
            a = torch.randn((64, 16), generator=generator, device=device).bfloat16()
            b = torch.randn((9, n, 16), generator=generator, device=device).bfloat16()
            d = conv_wgmma_selftest(a, b, tap)
            bt = b[tap].double().T
            ref = torch.matmul(a.double(), bt)
            scale = torch.matmul(a.double().abs(), bt.abs()).clamp_min(1e-30)
            err = ((d.double() - ref).abs() / scale).max().item()
            if not err <= 1e-5:
                raise AssertionError(f"conv wgmma self-test at N {n}, tap {tap}: d differs "
                                     f"from torch.matmul by {err:.3g} of the sum of |terms|")
            worst = max(worst, err)
    return worst


def check_wgmma_selftest(generator):
    """Runs :func:`wgmma_selftest` at :data:`WGMMA_SELFTEST_CASES` on
    N(0, 1) bf16 values drawn from the CUDA ``generator`` and asserts that
    every entry of d equals ``torch.matmul`` of the same values in f64
    within 1e-5 of its sum of |terms|: 16 exact bf16 products summed in f32
    are within 16 * 2**-23 of it.  Returns the largest error in those
    units."""
    device = generator.device
    worst = 0.0
    for rows, row in WGMMA_SELFTEST_CASES:
        a = torch.randn((64, 16), generator=generator, device=device).bfloat16()
        b = torch.randn((rows, 32), generator=generator, device=device).bfloat16()
        d = wgmma_selftest(a, b, row)
        rows_b = b[row:row + 16].double()
        ref = torch.matmul(a.double(), rows_b)
        scale = torch.matmul(a.double().abs(), rows_b.abs()).clamp_min(1e-30)
        err = ((d.double() - ref).abs() / scale).max().item()
        if not err <= 1e-5:
            raise AssertionError(f"wgmma self-test at rows {rows}, row {row}: d differs from "
                                 f"torch.matmul by {err:.3g} of the sum of |terms|")
        worst = max(worst, err)
    return worst


#: (B, H, W, C, F, S) at which the halo launches are checked: the mid 3x3
#: conv of each ResNet-50 stage at 448 px, batch 24, split over S = 2
#: spatial columns (shards of 56 x 112 ... 7 x 14; 7 x 14 = 98 pixels, whose
#: bf16 plane is only 4-byte aligned), and stage 4 over S = 4 (its 14 rows
#: in blocks of 4, 4, 4 and 2)
HALO_CASES = [case + (2,) for case in STAGE_SHAPES_448] + [STAGE_SHAPES_448[3] + (4,)]
#: Σy and Σy² of the shards, added, against the whole-image launch's: both
#: sum the same rounded y in other orders, within this share of Σ|y| (Σy²)
SUM_OF_ABS = 1e-6


def row_shards(x, spatial):
    """``[(a, b, top, bottom)]``: the row blocks of ``ceil(H / spatial)`` of
    an NCHW ``x`` (the last ones shorter; empty ones left out) with their
    halo rows, None at the image's edge."""
    h = x.shape[2]
    per = -(-h // spatial)
    out = []
    for a in range(0, h, per):
        b = min(a + per, h)
        out.append((a, b, x[:, :, a - 1:a].contiguous() if a else None,
                    x[:, :, b:b + 1].contiguous() if b < h else None))
    return out


def check_halo_shards(x, w, dy, spatial):
    """Launches both kernels on each row block of the CUDA ``x`` (and dy)
    with its halo rows, synchronizing after each, and asserts: y, the sums
    and dw equal the plain halo versions' within the bounds of
    :func:`check_against_plain`; each block's y equals the rows of the
    whole-image launch bitwise (each pixel's products are summed in the
    same order); Σy and Σy² added over the blocks equal the whole-image
    launch's within :data:`SUM_OF_ABS` of Σ|y|; dw added over the blocks
    equals the whole-image dw within :data:`DW_OF_MAX` of max |dw|.
    Returns the largest differences."""
    y_w, s_w, ss_w = conv3x3._launch_conv_bn_stats(x, w)
    dw_w = conv3x3._launch_filter_grad(x, dy)
    torch.cuda.synchronize()
    tol = CHECK_TOL[x.dtype]
    s_sum = torch.zeros_like(s_w, dtype=torch.float64)
    ss_sum = torch.zeros_like(ss_w, dtype=torch.float64)
    dw_sum = torch.zeros_like(dw_w, dtype=torch.float64)
    worst = {"y_vs_plain": 0.0, "y_vs_whole_bitwise": True, "y_vs_whole": 0.0,
             "dw_vs_plain_of_max": 0.0}
    for a, b, top, bottom in row_shards(x, spatial):
        xs, dys = x[:, :, a:b].contiguous(), dy[:, :, a:b].contiguous()
        y, s, ss = conv3x3._launch_conv_bn_stats(xs, w, top, bottom)
        torch.cuda.synchronize()
        dw = conv3x3._launch_filter_grad(xs, dys, top, bottom)
        torch.cuda.synchronize()
        y_p, _, _ = conv3x3._plain_conv_bn_stats(xs, w, top, bottom)
        torch.testing.assert_close(y.float(), y_p.float(), **tol["y"])
        worst["y_vs_plain"] = max(worst["y_vs_plain"],
                                  (y.float() - y_p.float()).abs().max().item())
        whole = y_w[:, :, a:b]
        worst["y_vs_whole_bitwise"] &= bool(torch.equal(y, whole))
        worst["y_vs_whole"] = max(worst["y_vs_whole"],
                                  (y.float() - whole.float()).abs().max().item())
        dw64 = conv3x3._plain_filter_grad(xs.double(), dys.double(),
                                  None if top is None else top.double(),
                                  None if bottom is None else bottom.double())
        of_max = ((dw.double() - dw64).abs().max() / dw64.abs().max()).item()
        if of_max > DW_OF_MAX:
            raise AssertionError(f"halo dw differs from f64 by {of_max:.3g} of max |dw|")
        worst["dw_vs_plain_of_max"] = max(worst["dw_vs_plain_of_max"], of_max)
        s_sum += s.double()
        ss_sum += ss.double()
        dw_sum += dw.double()
    yabs = y_w.double().abs()
    dims = (0, 2, 3)
    for got, want, scale, name in ((s_sum, s_w, yabs.sum(dims), "s"),
                                   (ss_sum, ss_w, (yabs * yabs).sum(dims), "ss")):
        err = ((got - want.double()).abs() / scale).max().item()
        if err > SUM_OF_ABS:
            raise AssertionError(f"{name} of the shards differs from the whole image's "
                                 f"by {err:.3g} of the sum of |terms|")
        worst[f"{name}_vs_whole_of_abs"] = err
    dw_err = ((dw_sum - dw_w.double()).abs().max() / dw_w.double().abs().max()).item()
    if dw_err > DW_OF_MAX:
        raise AssertionError(f"dw of the shards differs from the whole image's by "
                             f"{dw_err:.3g} of max |dw|")
    worst["dw_vs_whole_of_max"] = dw_err
    return worst


# ---------------------------------------------------------------------------
# conv1x1: the kernel against f64
# ---------------------------------------------------------------------------

#: (C, F, Ho, stride) of ResNet-50's 1x1 convs at 224 px (square maps; x is
#: Ho * stride wide), with how many of each a step runs: conv_a, conv_c and
#: the projection shortcuts of stages 1-4
RESNET50_1X1_SHAPES = [
    ((64, 64, 56, 1), 1), ((64, 256, 56, 1), 4), ((256, 64, 56, 1), 2),
    ((256, 128, 28, 2), 1), ((256, 512, 28, 2), 1), ((128, 512, 28, 1), 4),
    ((512, 128, 28, 1), 3), ((512, 256, 14, 2), 1), ((512, 1024, 14, 2), 1),
    ((256, 1024, 14, 1), 6), ((1024, 256, 14, 1), 5), ((1024, 512, 7, 2), 1),
    ((1024, 2048, 7, 2), 1), ((512, 2048, 7, 1), 3), ((2048, 512, 7, 1), 2)]
#: ragged cases (N, C, F, H, W, stride): channels past a tile; planes of a
#: multiple of 4 pixels (tensor copies) and not, with steps that span images;
#: an odd input at stride 2; planes of 1 pixel
CONV1X1_RAGGED_CASES = [(3, 40, 72, 9, 7, 1), (3, 40, 72, 6, 6, 1), (2, 130, 200, 4, 5, 1),
                        (2, 130, 70, 5, 5, 2), (5, 64, 200, 1, 1, 1), (2, 96, 64, 7, 6, 2)]
#: dw is held within :data:`DW_OF_MAX` of max |dw| of an f64 reference, the
#: 3x3 filter gradient's bound: the sums run over N*Ho*Wo <= 401,408
#: products as 3xTF32 (f32-exact to about 2**-20), 32 of them summed in the
#: tensor cores, then f32 adds


def conv1x1_check_inputs(n, c, f, h, w, stride, generator):
    """``(x, dy)`` of N(0, 1) f32 on ``generator``'s device."""
    device = generator.device
    x = torch.randn((n, c, h, w), generator=generator, device=device)
    dy = torch.randn((n, f, conv1x1.out_size(h, stride), conv1x1.out_size(w, stride)),
                     generator=generator, device=device)
    return x, dy


def conv1x1_reference(x, dy, stride):
    """dw in f64 as one matrix product: dy (F, K) @ x's strided pixels (K, C)."""
    xs = x[:, :, ::stride, ::stride].double()
    a = dy.double().transpose(0, 1).reshape(dy.shape[1], -1)
    b = xs.transpose(0, 1).reshape(x.shape[1], -1)
    return (a @ b.T)[:, :, None, None]


def conv1x1_check_against_f64(x, dy, stride):
    """Launches the kernel on CUDA tensors twice, synchronizing, and asserts
    that dw is within :data:`DW_OF_MAX` of max |dw| of
    :func:`conv1x1_reference` and that the two launches agree bitwise;
    returns its distance from f64 and cuDNN's (``conv2d_weight`` in f32,
    TF32 as the caller set it), in units of max |dw|."""
    dw = conv1x1._launch_filter_grad(x, dy, stride)
    torch.cuda.synchronize()
    again = conv1x1._launch_filter_grad(x, dy, stride)
    torch.cuda.synchronize()
    if not torch.equal(dw, again):
        raise AssertionError("conv1x1_filter_grad differs between two launches")
    ref = conv1x1_reference(x, dy, stride)
    scale = ref.abs().max().item()
    of_max = (dw.double() - ref).abs().max().item() / scale
    if not of_max <= DW_OF_MAX:
        raise AssertionError(f"conv1x1_filter_grad differs from f64 by {of_max:.3g} of max "
                             f"|dw| (bound {DW_OF_MAX:.3g})")
    plain = conv1x1._plain_filter_grad(x, dy, stride)
    return {"dw_vs_f64_of_max": of_max,
            "plain_dw_vs_f64_of_max": (plain.double() - ref).abs().max().item() / scale}


# ---------------------------------------------------------------------------
# depthwise: the kernels against f64
# ---------------------------------------------------------------------------

#: (C, k, stride, H) of NASNet-A Large's depthwise convs at 224 px (square
#: maps), with how many of each a step runs: its 23 shapes, 220 layers
NASNET_SHAPES = [
    ((42, 5, 2, 111), 1), ((96, 5, 2, 111), 1), ((96, 7, 2, 111), 2),
    ((42, 3, 1, 56), 2), ((42, 5, 1, 56), 2), ((42, 7, 1, 56), 2),
    ((84, 5, 2, 56), 2), ((84, 7, 2, 56), 2),
    ((84, 3, 1, 28), 2), ((84, 5, 1, 28), 2), ((84, 7, 1, 28), 2),
    ((168, 3, 1, 28), 36), ((168, 5, 1, 28), 24),
    ((336, 5, 2, 28), 2), ((336, 7, 2, 28), 2),
    ((336, 3, 1, 14), 38), ((336, 5, 1, 14), 26), ((336, 7, 1, 14), 2),
    ((672, 5, 2, 14), 2), ((672, 7, 2, 14), 2),
    ((672, 3, 1, 7), 38), ((672, 5, 1, 7), 26), ((672, 7, 1, 7), 2)]
#: ragged cases (N, C, H, W, k, stride): odd and even maps at both strides
#: (the asymmetric pads of stride 2 on even maps), planes that are not whole
#: 16-byte quads, maps smaller than the filter, a plane cut into bands
DEPTHWISE_RAGGED_CASES = [(3, 5, 9, 7, 3, 1), (2, 6, 8, 10, 5, 2), (3, 4, 11, 11, 7, 2),
                          (2, 7, 6, 6, 7, 1), (5, 3, 1, 1, 3, 2), (3, 9, 13, 13, 5, 1),
                          (2, 2, 2, 5, 7, 2), (2, 3, 141, 139, 5, 2), (4, 2, 120, 120, 3, 1)]
#: each output within this share of max |output| of an f64 reference:
#: f32 FMAs, y and dx of at most 49 terms (k^2 roundings, 49 * 2**-24 of
#: their sum of magnitudes at worst), dw of up to N * Ho * Wo = 401,408
#: terms summed in fixed-order chains of a few hundred terms a thread, then
#: across the block's threads and the cluster's blocks
DEPTHWISE_OF_MAX = 1e-5


def depthwise_check_inputs(n, c, h, w, k, stride, generator):
    """``(x, w, dy)`` of N(0, 1) f32 on ``generator``'s device."""
    device = generator.device
    x = torch.randn((n, c, h, w), generator=generator, device=device)
    wt = torch.randn((c, 1, k, k), generator=generator, device=device)
    dy = torch.randn((n, c, depthwise.out_size(h, stride), depthwise.out_size(w, stride)),
                     generator=generator, device=device)
    return x, wt, dy


def depthwise_reference(x, w, dy, stride):
    """(y, dx, dw) of the three passes in f64."""
    k, (h, wd) = w.shape[-1], x.shape[2:]
    x, w, dy = x.double(), w.double(), dy.double()
    return (depthwise._plain_forward(x, w, stride),
            depthwise._plain_input_grad(dy, w, h, wd, stride),
            depthwise._plain_grad_weight(x, dy, k, stride))


def depthwise_check_against_f64(x, w, dy, stride):
    """Launches the three kernels on CUDA tensors (the weight gradient
    twice), synchronizing, and asserts that each output is within
    :data:`DEPTHWISE_OF_MAX` of max |output| of :func:`depthwise_reference`
    and that the two dw agree bitwise; returns each output's distance from
    f64 and ATen's (``F.conv2d`` and its gradients, TF32 as the caller set
    it), in units of max |output|."""
    k, (h, wd) = w.shape[-1], x.shape[2:]
    outs = [depthwise._launch_forward(x, w, stride),
            depthwise._launch_input_grad(dy, w, h, wd, stride),
            depthwise._launch_grad_weight(x, dy, k, stride)]
    torch.cuda.synchronize()
    again = depthwise._launch_grad_weight(x, dy, k, stride)
    torch.cuda.synchronize()
    if not torch.equal(outs[2], again):
        raise AssertionError("depthwise grad_weight differs between two launches")
    refs = depthwise_reference(x, w, dy, stride)
    plain = [depthwise._plain_forward(x, w, stride),
             depthwise._plain_input_grad(dy, w, h, wd, stride),
             depthwise._plain_grad_weight(x, dy, k, stride)]
    out = {}
    for name, got, ref, lib in zip(("y", "dx", "dw"), outs, refs, plain):
        scale = ref.abs().max().item() or 1.0
        of_max = (got.double() - ref).abs().max().item() / scale
        if not of_max <= DEPTHWISE_OF_MAX:
            raise AssertionError(f"depthwise {name} differs from f64 by {of_max:.3g} of max "
                                 f"|{name}| (bound {DEPTHWISE_OF_MAX:.3g})")
        out[f"{name}_vs_f64_of_max"] = of_max
        out[f"aten_{name}_vs_f64_of_max"] = (lib.double() - ref).abs().max().item() / scale
    return out
