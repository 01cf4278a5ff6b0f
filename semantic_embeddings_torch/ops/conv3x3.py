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
:func:`instance` names what a dtype runs; :mod:`.checks` runs each
kernel's ``wgmma`` product on its own and holds the kernels against the
plain versions.  For CPU tensors the plain versions run.  The dispatcher picks by the tensor's device, nothing else:
there is no fallback from a kernel to its plain version.
``launches_conv_bn_stats`` / ``launches_filter_grad`` count kernel
launches, so that a run can show that its steps went through them.
"""

from __future__ import annotations

import ctypes
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
