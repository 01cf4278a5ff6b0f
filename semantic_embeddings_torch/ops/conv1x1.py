"""The f32 weight gradient of a 1x1 convolution: a CUDA kernel and its plain
version, and the autograd function through which the ResNet family's 1x1
convs run.

In the port's NCHW layout, for x (N, C, H, W), dy (N, F, Ho, Wo) and stride
s (1 or 2; a 1x1 conv's SAME padding is zero at either):

  filter_grad(x, dy, s):  dw[f, c, 0, 0] = sum_{n,i,j} dy[n, f, i, j]
                          * x[n, c, s*i, s*j], in f32

The kernel replaces no TPU kernel (the JAX package leaves the 1x1 convs to
XLA): it was added because cuDNN's f32 weight gradient with TF32 off runs
on the FMA units, a seventh of what the tensor cores give f32-exact
products as 3xTF32 (``csrc/conv1x1_filter_grad.cu`` says how).

:func:`conv1x1_filter_grad` is the ``torch.library`` custom op
``semantic_embeddings_torch::conv1x1_filter_grad`` with a fake
implementation; for CUDA tensors it launches the kernel, built by
:mod:`.._build` at first use, or the wrapper raises; for CPU tensors it runs
the plain version (``torch.nn.grad.conv2d_weight``, upcast to f32).

:func:`conv1x1` runs a block's 1x1 conv module: where :func:`engages` says
so, through :class:`Conv1x1`, whose forward is the conv's own ``F.conv2d``
call and whose backward gives dx by ``torch.nn.grad.conv2d_input`` (cuDNN,
as before) and dw by the op; anywhere else it calls the module, exactly as
before.  The choice is made from what the call can see, before any launch:
no kernel falls back to anything.  ``launches_filter_grad`` counts kernel
launches, so that a run can show its steps went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..parallel import spatial

#: kernel launches since the process started (or since a caller reset them)
launches_filter_grad = 0
#: device types whose f32 1x1 convs take the op (the kernel's)
KERNEL_DEVICES = ("cuda",)
#: the channel counts the kernel's tiles take whole: multiples of this
TILE_CHANNELS = 64

_lib = None
#: ``(splits, chunk)`` by what the split rule reads: the shape, whether each
#: operand is 16-byte aligned (the tensor copies' condition), the device
_splits_cache = {}


def _kernel():
    """The filter-gradient library, built and loaded."""
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("conv1x1_filter_grad")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv1x1_filter_grad_splits.argtypes = [ptr, ptr] + [i32] * 6 + [ctypes.POINTER(i32)]
        lib.conv1x1_filter_grad_splits.restype = i32
        lib.conv1x1_filter_grad.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
        lib.conv1x1_filter_grad.restype = i32
        lib.conv1x1_filter_grad_instance.argtypes = [ptr, ptr] + [i32] * 4
        lib.conv1x1_filter_grad_instance.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def out_size(size, stride):
    """A 1x1 conv's output extent (TF SAME, zero padding): ceil(size / s)."""
    return -(-size // stride)


# ---------------------------------------------------------------------------
# Plain version (CPU path; the reference the kernel is held against)
# ---------------------------------------------------------------------------


def _plain_filter_grad(x, dy, stride):
    """dw (F, C, 1, 1) in f32 (or wider), computed in x's dtype."""
    dw = torch.nn.grad.conv2d_weight(x, (dy.shape[1], x.shape[1], 1, 1), dy.to(x.dtype),
                                     stride=stride)
    return dw.to(torch.promote_types(dw.dtype, torch.float32))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check(x, dy, stride):
    """Raises unless x (N, C, H, W) and dy (N, F, ceil(H / s), ceil(W / s))
    are contiguous non-empty f32 tensors on one CUDA device."""
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"conv1x1_filter_grad kernel needs its operands on one CUDA device; "
                         f"got {x.device} and {dy.device}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"conv1x1_filter_grad kernel takes f32 operands, not {x.dtype} and "
                        f"{dy.dtype}")
    if x.ndim != 4 or dy.ndim != 4 or min(x.shape) < 1 or min(dy.shape) < 1 or stride < 1:
        raise ValueError(f"conv1x1_filter_grad kernel needs non-empty 4-D operands and a "
                         f"stride >= 1; got {tuple(x.shape)}, {tuple(dy.shape)}, {stride}")
    n, _, h, w = x.shape
    if (dy.shape[0], dy.shape[2], dy.shape[3]) != (n, out_size(h, stride), out_size(w, stride)):
        raise ValueError(f"conv1x1_filter_grad kernel: dy {tuple(dy.shape)} is not the output "
                         f"of x {tuple(x.shape)} at stride {stride}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv1x1_filter_grad kernel needs contiguous NCHW operands")
    if n * dy.shape[2] * dy.shape[3] >= 2**31:
        raise ValueError("conv1x1_filter_grad kernel indexes N*Ho*Wo pixels with 32-bit ints")


def _launch_filter_grad(x, dy, stride):
    global launches_filter_grad
    _check(x, dy, stride)
    n, c, h, w = x.shape
    f, ho, wo = dy.shape[1:]
    count, chunk = splits(x, dy, stride)
    dw = torch.empty((f, c, 1, 1), dtype=torch.float32, device=x.device)
    # the split partials (at most 64 MB); one split writes dw itself
    part = (torch.empty((count, f, c), dtype=torch.float32, device=x.device)
            if count > 1 else None)
    code = _kernel().conv1x1_filter_grad(
        x.data_ptr(), dy.data_ptr(), None if part is None else part.data_ptr(), dw.data_ptr(),
        n, c, h, w, f, ho, wo, stride, count, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"conv1x1_filter_grad kernel launch failed: CUDA error {code}")
    launches_filter_grad += 1
    return dw


def instance(x, dy, stride):
    """What the kernel runs for these CUDA operands (its tile, and whether
    tensor copies or the threads load them), as its library reports it."""
    return _kernel().conv1x1_filter_grad_instance(
        x.data_ptr(), dy.data_ptr(), x.shape[1], dy.shape[1], dy.shape[2] * dy.shape[3],
        stride).decode()


def splits(x, dy, stride):
    """``(splits, steps of 32 pixels a split)`` that the kernel takes for
    these CUDA operands on their device: the library's split rule, asked
    once for each shape, alignment and device."""
    n, c = x.shape[:2]
    f, ho, wo = dy.shape[1:]
    key = (n, c, f, ho, wo, stride, x.data_ptr() % 16 == 0, dy.data_ptr() % 16 == 0,
           x.device.index)
    if key not in _splits_cache:
        chunk = ctypes.c_int()
        count = _kernel().conv1x1_filter_grad_splits(x.data_ptr(), dy.data_ptr(), n, c, f, ho,
                                                     wo, stride, ctypes.byref(chunk))
        if count < 1:
            raise RuntimeError("conv1x1_filter_grad could not query the CUDA device")
        _splits_cache[key] = (count, chunk.value)
    return _splits_cache[key]


# ---------------------------------------------------------------------------
# The custom op: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------


@torch.library.custom_op("semantic_embeddings_torch::conv1x1_filter_grad",
                         mutates_args=(), device_types="cpu")
def conv1x1_filter_grad(x: torch.Tensor, dy: torch.Tensor, stride: int) -> torch.Tensor:
    """dw (F, C, 1, 1) of a 1x1 conv of this stride, in f32 (f64 for f64
    operands on the CPU)."""
    return _plain_filter_grad(x, dy, stride)


@conv1x1_filter_grad.register_kernel("cuda")
def _(x, dy, stride):
    return _launch_filter_grad(x, dy, stride)


@conv1x1_filter_grad.register_fake
def _(x, dy, stride):
    if x.ndim != 4 or dy.ndim != 4:
        raise ValueError(f"conv1x1_filter_grad needs 4-D operands; got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    torch._check(x.shape[0] == dy.shape[0],
                 lambda: f"conv1x1_filter_grad: operands of shapes {tuple(x.shape)} and "
                         f"{tuple(dy.shape)} do not fit")
    return x.new_empty((dy.shape[1], x.shape[1], 1, 1),
                       dtype=torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# Autograd, and where the op engages
# ---------------------------------------------------------------------------


class Conv1x1(torch.autograd.Function):
    """``F.conv2d(x, w, None, stride)`` for a 1x1 ``w``; its backward gives
    dx by ``torch.nn.grad.conv2d_input`` and dw by ``filter_grad(x, dy,
    stride)`` (the op, or its plain version)."""

    @staticmethod
    def forward(ctx, x, w, stride, filter_grad):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.filter_grad = stride, filter_grad
        return F.conv2d(x, w, None, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, g, stride=ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = ctx.filter_grad(x, g, ctx.stride).to(w.dtype)
        return dx, dw, None, None


def engages(conv, x):
    """Whether ``conv`` (an ``nn.Conv2d``) applied to ``x`` takes the op: an
    f32 x and weight on a device of :data:`KERNEL_DEVICES`, outside autocast,
    with grad enabled and the weight trained, no spatial grid, a 1x1 kernel
    with one stride, no bias, groups, padding or dilation, and channel
    counts that are multiples of :data:`TILE_CHANNELS`.  Anything else
    (bf16 under autocast, ``--spatial``, inference, export) keeps the
    module's own call."""
    w = conv.weight
    return (x.device.type in KERNEL_DEVICES and w.device == x.device
            and x.dtype == torch.float32 and w.dtype == torch.float32 and x.ndim == 4
            and not torch.is_autocast_enabled(x.device.type)
            and torch.is_grad_enabled() and w.requires_grad
            and not spatial.active()
            and tuple(conv.kernel_size) == (1, 1) and conv.stride[0] == conv.stride[1]
            and conv.bias is None and conv.groups == 1
            and tuple(conv.padding) == (0, 0) and tuple(conv.dilation) == (1, 1)
            and w.shape[0] % TILE_CHANNELS == 0 and w.shape[1] % TILE_CHANNELS == 0)


def conv1x1(conv, x, filter_grad=None):
    """``conv(x)`` for a block's 1x1 conv: where :func:`engages`, through
    :class:`Conv1x1` with dw by ``filter_grad`` (by default the op, looked
    up at the call), else the module's own call."""
    if not engages(conv, x):
        return conv(x)
    return Conv1x1.apply(x, conv.weight, conv.stride[0], filter_grad or conv1x1_filter_grad)


#: :func:`conv1x1` with dw from the plain version (a reference)
plain_conv1x1 = functools.partial(conv1x1, filter_grad=_plain_filter_grad)
