"""3x3 SAME stride-1 convolution with BatchNorm statistics, and its filter
gradient: two CUDA kernels and their plain versions.

Counterparts of ``tools/fused_conv_bn_prototype.py::conv3x3_bn_stats`` and
``tools/conv_filter_grad_prototype.py::conv3x3_filter_grad``, in the port's
NCHW layout with (F, C, 3, 3) weights:

  conv_bn_stats(x, w):  y = conv(x, w) rounded to x's dtype, and the f32
                        per-channel sums s = sum(y), ss = sum(y * y) of that
                        rounded y over (N, H, W)
  filter_grad(x, dy):   dw[f, c, kh, kw] = sum_{n,h,w} x_pad[n, c, h+kh, w+kw]
                        * dy[n, f, h, w], in f32

Both take optional halo rows ``top`` and ``bottom``, (N, C, 1, W) in x's
dtype: x's rows -1 and H where x is one block of rows of a larger image (a
shard of spatial partitioning, :mod:`..parallel.spatial`), in place of the
SAME padding's zero rows; y, the sums and dy cover x's own rows.  Without
them (None, a null pointer to the kernels) both are what they were.

:func:`conv3x3_bn_stats` is the op through which every ResNet ``conv_b`` +
``bn_b`` pair runs.  Both functions are ``torch.library`` custom ops,
``semantic_embeddings_torch::conv3x3_bn_stats`` and
``::conv3x3_filter_grad``, each with a fake implementation, so that graphs
through them trace and export (an exported ResNet holds one
``conv3x3_bn_stats`` node per ``conv_b``).  The first op's registered
autograd adds the statistics' cotangents to y's (``g_y + g_s + 2 y g_ss``),
computes dx with ``torch.nn.grad.conv2d_input`` (the JAX package leaves dx
to XLA too) and dw with the second op.

For CUDA tensors each op launches its kernel (``csrc/conv3x3_bn_stats.cu``,
``csrc/conv3x3_filter_grad.cu``, built by :mod:`.._build` at first use), or
the wrapper raises.  Each has two instances, chosen by the dtype, and all
four run on Hopper's warpgroup ``wgmma``: bf16 products in bf16, f32 ones as
3xTF32 (three TF32 products for each f32-exact one) on TF32 ``wgmma``.
:func:`instance` names what a dtype runs; :func:`wgmma_selftest`,
:func:`conv_wgmma_selftest`, :func:`tf32_selftest` and
:func:`conv_tf32_selftest` run each kernel's ``wgmma`` product on its own.  For CPU tensors the plain
versions run.  The dispatcher picks by the tensor's device, nothing else:
there is no fallback from a kernel to its plain version.
``launches_conv_bn_stats`` / ``launches_filter_grad`` count kernel
launches, so that a run can show that its steps went through them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

#: kernel launches since the process started (or since a caller reset them)
launches_conv_bn_stats = 0
launches_filter_grad = 0
#: of those, the launches given a halo row (top or bottom)
launches_conv_bn_stats_halo = 0
launches_filter_grad_halo = 0

_libs = None


def _kernels():
    """(conv + stats library, filter-gradient library), built and loaded."""
    global _libs
    if _libs is None:
        from .._build import load

        _libs = declare(load("conv3x3_bn_stats"), load("conv3x3_filter_grad"))
    return _libs


def declare(fwd, wgrad):
    """``(fwd, wgrad)`` with the C functions' argument and result types
    declared: the libraries of ``csrc/conv3x3_bn_stats.cu`` and
    ``csrc/conv3x3_filter_grad.cu`` (conv_clocks.py passes its probed
    builds)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd.conv3x3_bn_stats_partial_rows.argtypes = [i32] * 3
    fwd.conv3x3_bn_stats_partial_rows.restype = i32
    fwd.conv3x3_bn_stats_scratch.argtypes = [ptr] + [i32] * 6
    fwd.conv3x3_bn_stats_scratch.restype = ctypes.c_longlong
    fwd.conv3x3_bn_stats_copy_width.argtypes = [ptr, i32, i32, i32]
    fwd.conv3x3_bn_stats_copy_width.restype = i32
    fwd.conv3x3_bn_stats.argtypes = [ptr] * 9 + [i32] * 6 + [ptr, ptr]
    fwd.conv3x3_bn_stats.restype = i32
    fwd.conv3x3_bn_stats_wgmma_selftest.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    fwd.conv3x3_bn_stats_wgmma_selftest.restype = i32
    fwd.conv3x3_bn_stats_tf32_selftest.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    fwd.conv3x3_bn_stats_tf32_selftest.restype = i32
    wgrad.conv3x3_filter_grad_splits.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    wgrad.conv3x3_filter_grad_splits.restype = i32
    wgrad.conv3x3_filter_grad.argtypes = [ptr] * 6 + [i32] * 8 + [ptr, ptr]
    wgrad.conv3x3_filter_grad.restype = i32
    wgrad.conv3x3_filter_grad_copy_width.argtypes = [ptr, ptr, i32, i32, i32]
    wgrad.conv3x3_filter_grad_copy_width.restype = i32
    wgrad.conv3x3_filter_grad_scratch.argtypes = [ptr, ptr] + [i32] * 6
    wgrad.conv3x3_filter_grad_scratch.restype = ctypes.c_longlong
    wgrad.conv3x3_filter_grad_wgmma_selftest.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    wgrad.conv3x3_filter_grad_wgmma_selftest.restype = i32
    wgrad.conv3x3_filter_grad_tf32_selftest.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    wgrad.conv3x3_filter_grad_tf32_selftest.restype = i32
    for lib, name in ((fwd, "conv3x3_bn_stats"), (wgrad, "conv3x3_filter_grad")):
        query = getattr(lib, f"{name}_instance")
        query.argtypes, query.restype = [i32], ctypes.c_char_p
    return fwd, wgrad


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------


def _upcast(t):
    """bf16 -> f32, f32 -> f32, f64 -> f64 (the models' ``upcast32``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _halo_extended(x, top, bottom):
    """x with its rows -1 and H on: the halo rows given, zeros for those not."""
    def row(halo):
        return halo if halo is not None else x.new_zeros(x.shape[:2] + (1, x.shape[3]))

    return torch.cat([row(top), x, row(bottom)], dim=2)


def _plain_conv_bn_stats(x, w, top=None, bottom=None):
    if top is None and bottom is None:
        y = F.conv2d(x, w, padding=1)
    else:  # the halo rows on, then W padded only
        y = F.conv2d(_halo_extended(x, top, bottom), w, padding=(0, 1))
    yf = _upcast(y)
    return y, yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))


def _plain_filter_grad(x, dy, top=None, bottom=None):
    """dw in f32 (or wider), computed in x's dtype as the prototype's
    reference does."""
    shape = (dy.shape[1], x.shape[1], 3, 3)
    dy = dy.to(x.dtype)
    if top is None and bottom is None:
        return _upcast(torch.nn.grad.conv2d_weight(x, shape, dy, padding=1))
    return _upcast(torch.nn.grad.conv2d_weight(
        _halo_extended(x, top, bottom), shape, dy, padding=(0, 1)))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(x, other, what):
    """Raises unless ``x`` (N, C, H, W) and ``other`` are contiguous f32 or
    bf16 tensors of one dtype on one CUDA device."""
    if x.device.type != "cuda" or other.device != x.device:
        raise ValueError(
            f"{what} kernel needs its operands on one CUDA device; got "
            f"{x.device} and {other.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or other.dtype != x.dtype:
        raise TypeError(
            f"{what} kernel takes f32 or bf16 operands of one dtype, not "
            f"{x.dtype} and {other.dtype}")
    if x.ndim != 4 or other.ndim != 4 or min(x.shape) < 1 or min(other.shape) < 1:
        raise ValueError(
            f"{what} kernel needs non-empty 4-D operands; got "
            f"{tuple(x.shape)} and {tuple(other.shape)}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous NCHW operands")
    if x.shape[0] * x.shape[2] * x.shape[3] >= 2**31:
        raise ValueError(f"{what} kernel indexes N*H*W rows with 32-bit ints")


def _check_halos(x, top, bottom, what):
    """Raises unless each halo row given is a contiguous (N, C, 1, W) tensor
    of x's dtype on x's device."""
    want = x.shape[:2] + (1, x.shape[3])
    for name, halo in (("top", top), ("bottom", bottom)):
        if halo is None:
            continue
        if halo.shape != want or halo.dtype != x.dtype or halo.device != x.device:
            raise ValueError(
                f"{what} kernel needs the {name} halo as x's row: {tuple(want)} "
                f"{x.dtype} on {x.device}; got {tuple(halo.shape)} {halo.dtype} on "
                f"{halo.device}")
        if not halo.is_contiguous():
            raise ValueError(f"{what} kernel needs a contiguous {name} halo")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(code, what):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")


def _launch_conv_bn_stats(x, w, top=None, bottom=None):
    global launches_conv_bn_stats, launches_conv_bn_stats_halo
    _check(x, w, "conv3x3_bn_stats")
    _check_halos(x, top, bottom, "conv3x3_bn_stats")
    b, c, h, wd = x.shape
    f = w.shape[0]
    if tuple(w.shape) != (f, c, 3, 3):
        raise ValueError(
            f"conv3x3_bn_stats kernel needs w of shape ({f}, {c}, 3, 3); got "
            f"{tuple(w.shape)}")
    lib = _kernels()[0]
    bf16 = int(x.dtype == torch.bfloat16)
    rows = lib.conv3x3_bn_stats_partial_rows(b, h, wd)
    y = torch.empty((b, f, h, wd), dtype=x.dtype, device=x.device)
    part_s, part_ss = torch.empty((2, rows, f), dtype=torch.float32, device=x.device)
    s = torch.empty(f, dtype=torch.float32, device=x.device)
    ss = torch.empty(f, dtype=torch.float32, device=x.device)
    # the weight permuted into the kernel's slices, and x repacked into
    # padded planes where its planes do not suit the tensor copies
    nbytes = lib.conv3x3_bn_stats_scratch(x.data_ptr(), b, c, h, wd, f, bf16)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.conv3x3_bn_stats(
        x.data_ptr(), w.data_ptr(), _ptr(top), _ptr(bottom), y.data_ptr(), part_s.data_ptr(),
        part_ss.data_ptr(), s.data_ptr(), ss.data_ptr(), b, c, h, wd, f, bf16,
        scratch.data_ptr(), stream)
    _raise_on(code, "conv3x3_bn_stats")
    launches_conv_bn_stats += 1
    launches_conv_bn_stats_halo += top is not None or bottom is not None
    return y, s, ss


def _launch_filter_grad(x, dy, top=None, bottom=None):
    global launches_filter_grad, launches_filter_grad_halo
    _check(x, dy, "conv3x3_filter_grad")
    _check_halos(x, top, bottom, "conv3x3_filter_grad")
    n, c, h, wd = x.shape
    f = dy.shape[1]
    if tuple(dy.shape) != (n, f, h, wd):
        raise ValueError(
            f"conv3x3_filter_grad kernel needs dy of shape ({n}, F, {h}, {wd}); "
            f"got {tuple(dy.shape)}")
    lib = _kernels()[1]
    bf16 = int(x.dtype == torch.bfloat16)
    chunk = ctypes.c_int()
    splits = lib.conv3x3_filter_grad_splits(n, c, h, wd, f, bf16, ctypes.byref(chunk))
    if splits < 1:
        raise RuntimeError("conv3x3_filter_grad could not query the CUDA device")
    part = torch.empty((splits, f, c * 9), dtype=torch.float32, device=x.device)
    dw = torch.empty((f, c, 3, 3), dtype=torch.float32, device=x.device)
    # operands that no cp.async width fits are repacked into padded planes
    nbytes = lib.conv3x3_filter_grad_scratch(x.data_ptr(), dy.data_ptr(), n, c, h, wd, f, bf16)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.conv3x3_filter_grad(
        x.data_ptr(), dy.data_ptr(), _ptr(top), _ptr(bottom), part.data_ptr(), dw.data_ptr(),
        n, c, h,
        wd, f, splits, chunk.value, bf16,
        None if scratch is None else scratch.data_ptr(), stream)
    _raise_on(code, "conv3x3_filter_grad")
    launches_filter_grad += 1
    launches_filter_grad_halo += top is not None or bottom is not None
    return dw


def filter_grad_copy_width(x, dy):
    """The copy width, in elements, that the filter-gradient kernel of x's
    dtype takes for these CUDA operands (H*W and both pointers must be
    multiples of it): 16 bytes, 8 elements in bf16 (``cp.async``) and 4 in
    f32 (tensor copies, whose planes must be whole 16 bytes), or 1 where
    that does not fit and the kernel first repacks both into planes padded
    to a multiple of 8 elements."""
    return _kernels()[1].conv3x3_filter_grad_copy_width(
        x.data_ptr(), dy.data_ptr(), x.shape[2], x.shape[3], int(x.dtype == torch.bfloat16))


def conv_bn_stats_copy_width(x):
    """The copy width, in elements, that the conv + statistics kernel of x's
    dtype takes for the CUDA tensor x (H*W and the pointer must be multiples
    of it): 16 bytes, bf16 8 and f32 4 (its tensor copies need planes of
    whole 16 bytes), or 1 where that does not fit and the kernel first
    repacks x into planes padded to a multiple of 8 elements."""
    return _kernels()[0].conv3x3_bn_stats_copy_width(
        x.data_ptr(), x.shape[2], x.shape[3], int(x.dtype == torch.bfloat16))


def instance(kernel, dtype):
    """What ``kernel`` ("conv3x3_bn_stats" or "conv3x3_filter_grad") runs on
    operands of ``dtype``, as its library reports it (which ``mma`` or
    ``wgmma``, and its tile)."""
    lib = _kernels()[0 if kernel == "conv3x3_bn_stats" else 1]
    return getattr(lib, f"{kernel}_instance")(int(dtype == torch.bfloat16)).decode()


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
    _check(a[None, None], b[None, None], "wgmma self-test")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"wgmma self-test takes bf16 operands, not {a.dtype}")
    d = torch.empty((64, 32), dtype=torch.float32, device=a.device)
    code = _kernels()[1].conv3x3_filter_grad_wgmma_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), b.shape[0], row,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(code, "wgmma self-test")
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
    _check(a[None, None], b[None, None], "tf32 self-test")
    if a.dtype != torch.float32:
        raise TypeError(f"tf32 self-test takes f32 operands, not {a.dtype}")
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    code = _kernels()[1].conv3x3_filter_grad_tf32_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), 64, a.shape[1] // 8, depth,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(code, "tf32 self-test")
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
    _check(a[None, None], b[None], "conv wgmma self-test")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"conv wgmma self-test takes bf16 operands, not {a.dtype}")
    n = b.shape[1]
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    code = _kernels()[0].conv3x3_bn_stats_wgmma_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), n, tap,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(code, "conv wgmma self-test")
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
    _check(a[None, None], b[None, None], "conv tf32 self-test")
    if a.dtype != torch.float32:
        raise TypeError(f"conv tf32 self-test takes f32 operands, not {a.dtype}")
    n = b.shape[0]
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    code = _kernels()[0].conv3x3_bn_stats_tf32_selftest(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), n, a.shape[1] // CONV_TF32_CHUNK, flush,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(code, "conv tf32 self-test")
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
# The custom ops: the kernels for CUDA tensors, the plain versions for CPU ones
# ---------------------------------------------------------------------------


def _check_shapes(x, other, dim, other_dim, what):
    """The fake implementations' check: x and ``other`` 4-D, agreeing in
    extent at x's ``dim`` and ``other``'s ``other_dim``, through
    ``torch._check``, which takes a symbolic batch."""
    if x.ndim != 4 or other.ndim != 4:
        raise ValueError(f"{what} needs 4-D operands; got {tuple(x.shape)} and "
                         f"{tuple(other.shape)}")
    torch._check(x.shape[dim] == other.shape[other_dim],
                 lambda: f"{what}: operands of shapes {tuple(x.shape)} and "
                         f"{tuple(other.shape)} do not fit")


@torch.library.custom_op("semantic_embeddings_torch::conv3x3_bn_stats",
                         mutates_args=(), device_types="cpu")
def conv3x3_bn_stats_op(x: torch.Tensor, w: torch.Tensor, top: Optional[torch.Tensor] = None,
                        bottom: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, s, ss)``: the 3x3 SAME conv y in x's dtype and the per-channel
    f32 sums of y and y**2 (f64 for f64 operands on the CPU); ``top`` and
    ``bottom`` are x's rows -1 and H where given (else zeros)."""
    return _plain_conv_bn_stats(x, w, top, bottom)


@conv3x3_bn_stats_op.register_kernel("cuda")
def _(x, w, top=None, bottom=None):
    return _launch_conv_bn_stats(x, w, top, bottom)


@conv3x3_bn_stats_op.register_fake
def _(x, w, top=None, bottom=None):
    _check_shapes(x, w, 1, 1, "conv3x3_bn_stats")  # C
    n, _, h, wd = x.shape
    f = w.shape[0]
    stats = torch.promote_types(x.dtype, torch.float32)
    return (x.new_empty((n, f, h, wd)), x.new_empty((f,), dtype=stats),
            x.new_empty((f,), dtype=stats))


@torch.library.custom_op("semantic_embeddings_torch::conv3x3_filter_grad",
                         mutates_args=(), device_types="cpu")
def conv3x3_filter_grad(x: torch.Tensor, dy: torch.Tensor, top: Optional[torch.Tensor] = None,
                        bottom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dw (F, C, 3, 3) in f32 (f64 for f64 operands on the CPU); ``top`` and
    ``bottom`` are x's rows -1 and H where given (else zeros)."""
    return _plain_filter_grad(x, dy, top, bottom)


@conv3x3_filter_grad.register_kernel("cuda")
def _(x, dy, top=None, bottom=None):
    return _launch_filter_grad(x, dy, top, bottom)


@conv3x3_filter_grad.register_fake
def _(x, dy, top=None, bottom=None):
    _check_shapes(x, dy, 0, 0, "conv3x3_filter_grad")  # N
    return x.new_empty((dy.shape[1], x.shape[1], 3, 3),
                       dtype=torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _total_cotangent(y, g_y, g_s, g_ss):
    """The cotangent of y through all three outputs, in f32 (or wider):
    ``g_y + g_s + 2 y g_ss`` with ``g_s`` and ``g_ss`` per channel."""
    yf = _upcast(y)
    d = _upcast(g_y) if g_y is not None else torch.zeros_like(yf)
    if g_s is not None:
        d = d + g_s.view(1, -1, 1, 1)
    if g_ss is not None:
        d = d + 2.0 * yf * g_ss.view(1, -1, 1, 1)
    return d


def _backward(ctx, g_y, g_s, g_ss, filter_grad):
    x, w, y, top, bottom = ctx.saved_tensors
    dx = dw = dtop = dbottom = None
    halos = top is not None or bottom is not None
    with torch.autocast(x.device.type, enabled=False):
        # dy in x's dtype, as the prototype's reference takes it
        dy = _total_cotangent(y, g_y, g_s, g_ss).to(x.dtype)
        if not halos and ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1)
        elif halos and any(ctx.needs_input_grad[i] for i in (0, 2, 3)):
            # dx over the H + 2 extended rows; the end rows are the halos'
            n, c, h, wd = x.shape
            dx_ext = torch.nn.grad.conv2d_input((n, c, h + 2, wd), w, dy, padding=(0, 1))
            dx = dx_ext[:, :, 1:h + 1] if ctx.needs_input_grad[0] else None
            dtop = dx_ext[:, :, :1] if top is not None and ctx.needs_input_grad[2] else None
            dbottom = (dx_ext[:, :, h + 1:] if bottom is not None and ctx.needs_input_grad[3]
                       else None)
        if ctx.needs_input_grad[1]:
            dw = filter_grad(x, dy, top, bottom).to(w.dtype)
    return dx, dw, dtop, dbottom


def _setup_context(ctx, inputs, output):
    x, w, top, bottom = inputs
    ctx.save_for_backward(x, w, output[0], top, bottom)


conv3x3_bn_stats_op.register_autograd(
    lambda ctx, g_y, g_s, g_ss: _backward(ctx, g_y, g_s, g_ss, conv3x3_filter_grad),
    setup_context=_setup_context)


class PlainConv3x3BNStats(torch.autograd.Function):
    """The custom op's autograd through the plain versions on any device:
    the reference that a train step through the kernels is held against.
    Nothing on the training path uses it."""

    @staticmethod
    def forward(ctx, x, w, top=None, bottom=None):
        ctx.set_materialize_grads(False)
        y, s, ss = _plain_conv_bn_stats(x, w, top, bottom)
        ctx.save_for_backward(x, w, y, top, bottom)
        return y, s, ss

    @staticmethod
    def backward(ctx, g_y, g_s, g_ss):
        return _backward(ctx, g_y, g_s, g_ss, _plain_filter_grad)


def _apply(function, x, w, top=None, bottom=None):
    # Under autocast, x, w and the halo rows are cast to the autocast dtype
    # (bf16 for --bf16) here, outside the op (autocast casts no custom op's
    # inputs), and the op runs with autocast off: both kernels then see bf16
    # x, w and dy; without autocast they see x's dtype (f32).  y is in that
    # dtype, the statistics and dw in f32.
    kind = x.device.type
    dtype = torch.get_autocast_dtype(kind) if torch.is_autocast_enabled(kind) else x.dtype

    def cast(t):
        return None if t is None else t.to(dtype).contiguous()

    with torch.autocast(kind, enabled=False):
        return function(cast(x), cast(w), cast(top), cast(bottom))


def conv3x3_bn_stats(x, w, top=None, bottom=None):
    """3x3 SAME stride-1 conv of NCHW ``x`` with (F, C, 3, 3) ``w``, returning
    ``(y, s, ss)``: y, and the f32 per-channel sums of y and y**2 over
    (N, H, W) that BatchNorm's batch statistics need; through the custom op
    ``semantic_embeddings_torch::conv3x3_bn_stats``.  ``top`` / ``bottom``:
    x's rows -1 and H, (N, C, 1, W), where x is a block of a larger image's
    rows (None: the image's edge, zeros)."""
    return _apply(conv3x3_bn_stats_op, x, w, top, bottom)


def plain_conv3x3_bn_stats(x, w, top=None, bottom=None):
    """:func:`conv3x3_bn_stats` through the plain versions (a reference)."""
    return _apply(PlainConv3x3BNStats.apply, x, w, top, bottom)


# ---------------------------------------------------------------------------
# Holding the kernels against the plain versions (on the card)
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
#: inputs (check_inputs: x and dy of N(0, 1), He-scaled w, so y is O(1)).
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


def check_inputs(case, dtype, generator):
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
    y, s, ss = _launch_conv_bn_stats(x, w)
    torch.cuda.synchronize()
    dw = _launch_filter_grad(x, dy)
    torch.cuda.synchronize()
    if y.dtype != x.dtype or dw.dtype != torch.float32:
        raise AssertionError(f"y is {y.dtype}, dw {dw.dtype} for {x.dtype} x")
    y_p, s_p, ss_p = _plain_conv_bn_stats(x, w)
    dw_p = _plain_filter_grad(x, dy)
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
    rows = _kernels()[0].conv3x3_bn_stats_partial_rows(x.shape[0], x.shape[2], x.shape[3])
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

    dw64 = _plain_filter_grad(x.double(), dy.double())
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
    y_w, s_w, ss_w = _launch_conv_bn_stats(x, w)
    dw_w = _launch_filter_grad(x, dy)
    torch.cuda.synchronize()
    tol = CHECK_TOL[x.dtype]
    s_sum = torch.zeros_like(s_w, dtype=torch.float64)
    ss_sum = torch.zeros_like(ss_w, dtype=torch.float64)
    dw_sum = torch.zeros_like(dw_w, dtype=torch.float64)
    worst = {"y_vs_plain": 0.0, "y_vs_whole_bitwise": True, "y_vs_whole": 0.0,
             "dw_vs_plain_of_max": 0.0}
    for a, b, top, bottom in row_shards(x, spatial):
        xs, dys = x[:, :, a:b].contiguous(), dy[:, :, a:b].contiguous()
        y, s, ss = _launch_conv_bn_stats(xs, w, top, bottom)
        torch.cuda.synchronize()
        dw = _launch_filter_grad(xs, dys, top, bottom)
        torch.cuda.synchronize()
        y_p, _, _ = _plain_conv_bn_stats(xs, w, top, bottom)
        torch.testing.assert_close(y.float(), y_p.float(), **tol["y"])
        worst["y_vs_plain"] = max(worst["y_vs_plain"],
                                  (y.float() - y_p.float()).abs().max().item())
        whole = y_w[:, :, a:b]
        worst["y_vs_whole_bitwise"] &= bool(torch.equal(y, whole))
        worst["y_vs_whole"] = max(worst["y_vs_whole"],
                                  (y.float() - whole.float()).abs().max().item())
        dw64 = _plain_filter_grad(xs.double(), dys.double(),
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
