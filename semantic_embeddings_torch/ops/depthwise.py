"""The f32 depthwise convolution of NASNet-A's separable blocks: three CUDA
kernels (forward, input gradient, weight gradient), their plain versions,
and the autograd function through which ``Conv2dSame`` sends such convs.

In the port's NCHW layout, for x (N, C, H, W), a filter w (C, 1, k, k) and
stride s, with TF SAME zero padding (pt rows before, pl columns before; the
odd pixel after) and Ho = ceil(H / s):

  forward:      y[n,c,i,j] = sum_{a,b} w[c,0,a,b] * x[n,c,s*i+a-pt, s*j+b-pl]
  input grad:   dx = the transpose of the forward, applied to dy
  weight grad:  dw[c,0,a,b] = sum_{n,i,j} dy[n,c,i,j] * x[n,c,s*i+a-pt, s*j+b-pl]

The kernels (``csrc/depthwise_conv.cu``) replace no TPU kernel (the JAX
package leaves depthwise convs to XLA): they were added because ATen's f32
NCHW depthwise kernels run NASNet-A's 220 depthwise convs at some 10% of
their bound, which is bytes (the source's head note says how the kernels
move each byte once).  Each pass launches exactly one kernel a call, named
as ATen's are (:data:`KERNEL_NAMES`), and nothing else: the SAME padding is
written in shared memory, not by ``F.pad``.

Each pass is a ``torch.library`` custom op with a fake implementation
(``semantic_embeddings_torch::depthwise_conv_forward``,
``::depthwise_conv_input_grad``, ``::depthwise_conv_grad_weight``); for
CUDA tensors it launches its kernel, built by :mod:`.._build` at first use,
or the wrapper raises; for CPU tensors it runs the plain version
(``F.conv2d`` and ``torch.nn.grad`` on the padded input).  :func:`plan`
chooses each launch's tiling from the shapes and the card's SM count.

:func:`depthwise_conv` runs a ``Conv2dSame`` through :class:`DepthwiseConv`
where :func:`engages` says so; anywhere else the module keeps its own call.
The choice is made from what the call can see, before any launch: no kernel
falls back to anything.  ``launches_forward``, ``launches_input_grad`` and
``launches_grad_weight`` count kernel launches, so that a run can show that
every depthwise conv went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..parallel import spatial

#: kernel launches since the process started (or since a caller reset them)
launches_forward = 0
launches_input_grad = 0
launches_grad_weight = 0
#: device types whose f32 depthwise convs take the op (the kernels')
KERNEL_DEVICES = ("cuda",)
#: the filter sizes and strides the kernels are built for
KERNELS = (3, 5, 7)
STRIDES = (1, 2)
#: each pass's kernel (its name starts as ATen's, for the benchmark's readers)
KERNEL_NAMES = {"forward": "conv_depthwise2d_forward_sm90_kernel",
                "input_grad": "conv_depthwise2d_backward_sm90_kernel",
                "grad_weight": "conv_depthwise2d_grad_weight_sm90_kernel"}

#: outputs a thread computes along a row at once (``J`` in the source)
RUN = 4
#: threads a block at most (128 ran NASNet-A's shapes on an H100 faster than
#: 256, and 48 KB tiles faster than 32 or 64 KB: PERF.md's kernel table)
THREADS = 128
#: shared memory a tile aims at (bytes): a tile larger than this is cut into
#: bands of rows; the kernels take up to the card's 227 KB
SMEM_TARGET = 48 * 1024
SMEM_MAX = 227 * 1024
#: blocks a channel (a cluster) at most, in the weight gradient, and the
#: blocks a SM that its clusters aim at
MAX_CLUSTER = 8
CLUSTER_BLOCKS_PER_SM = 4

_lib = None


def _kernel():
    """The depthwise library, built and loaded."""
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("depthwise_conv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("depthwise_conv_forward", "depthwise_conv_input_grad",
                     "depthwise_conv_grad_weight"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
        _lib = lib
    return _lib


def out_size(size, stride):
    """A SAME conv's output extent: ceil(size / s)."""
    return -(-size // stride)


def same_pads(size, k, stride):
    """TF SAME padding (before, after) along one axis."""
    total = max((out_size(size, stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------


def _pads(h, w, k, stride):
    """``F.pad``'s (left, right, top, bottom) of a SAME conv."""
    return same_pads(w, k, stride) + same_pads(h, k, stride)


def _plain_forward(x, w, stride):
    k = w.shape[-1]
    xp = F.pad(x, _pads(x.shape[2], x.shape[3], k, stride))
    return F.conv2d(xp, w.to(x.dtype), None, stride, groups=x.shape[1])


def _plain_input_grad(dy, w, height, width, stride):
    n, c = dy.shape[:2]
    k = w.shape[-1]
    left, right, top, bottom = _pads(height, width, k, stride)
    dxp = torch.nn.grad.conv2d_input((n, c, height + top + bottom, width + left + right),
                                     w.to(dy.dtype), dy, stride, groups=c)
    return dxp[:, :, top:top + height, left:left + width].contiguous()


def _plain_grad_weight(x, dy, k, stride):
    c = x.shape[1]
    xp = F.pad(x, _pads(x.shape[2], x.shape[3], k, stride))
    dw = torch.nn.grad.conv2d_weight(xp, (c, 1, k, k), dy.to(x.dtype), stride, groups=c)
    return dw.to(torch.promote_types(dw.dtype, torch.float32))


# ---------------------------------------------------------------------------
# The tiling of a launch
# ---------------------------------------------------------------------------


def _tile(kind, w, wo, k, stride, rows):
    """``(in_rows, in_stride, out_stride)`` of a tile of ``rows`` output
    rows: the input window's rows and the two tiles' row strides in floats
    (odd, so that rows an odd number apart fall in distinct banks), wide
    enough for the last run of :data:`RUN` outputs of a row."""
    if kind == "input_grad":  # dx (h, w) from dy (ho, wo)
        in_rows = (rows + k - 2) // stride + 1
        if stride == 1:
            width = _cdiv(w, RUN) * RUN + k - 1
        else:
            width = (2 * RUN * _cdiv(_cdiv(w, 2), RUN) + k - 2) // 2 + 1
        out_width = w
    else:
        in_rows = stride * (rows - 1) + k
        width = stride * (_cdiv(wo, RUN) * RUN - 1) + k
        out_width = _cdiv(wo, RUN) * RUN
    return in_rows, width | 1, out_width | 1


@functools.lru_cache(maxsize=None)
def plan(kind, n, c, h, w, k, stride, sms=132):
    """The launch of pass ``kind`` (``forward``, ``input_grad`` or
    ``grad_weight``) for x (n, c, h, w), a k x k filter and this stride on a
    card of ``sms`` SMs: ``(layout, threads, smem_bytes)``, the layout the 15
    ints of the source's ``Layout``.

    A tile is P whole planes, or a band of R rows of one plane where a
    plane's tile would pass :data:`SMEM_TARGET`; a thread takes one output
    row of the tile (at stride 2 the input gradient's rows are split by
    parity) and one of G groups of its runs, so that a block has at most
    :data:`THREADS` threads; the forward's and input gradient's blocks loop
    over the tiles, as many blocks as the card holds at once.  The weight
    gradient's cluster takes as many slices of the batch (at most
    :data:`MAX_CLUSTER`) as bring its blocks to :data:`CLUSTER_BLOCKS_PER_SM`
    a SM; the launcher halves it until all the blocks fit on the card at
    once."""
    ho, wo = out_size(h, stride), out_size(w, stride)
    pt, pl = same_pads(h, k, stride)[0], same_pads(w, k, stride)[0]
    height = h if kind == "input_grad" else ho  # the rows the tiles split
    cluster = 1
    if kind == "grad_weight":
        while (cluster < MAX_CLUSTER and cluster * 2 <= n
               and c * cluster < CLUSTER_BLOCKS_PER_SM * sms):
            cluster *= 2
    planes_max = _cdiv(n, cluster) if kind == "grad_weight" else n * c
    rows = height
    while True:
        in_rows, in_stride, out_stride = _tile(kind, w, wo, k, stride, rows)
        floats = in_rows * in_stride + rows * out_stride
        slots = 2 * _cdiv(rows, 2) if kind == "input_grad" and stride == 2 else rows
        if (4 * floats <= SMEM_TARGET and slots <= THREADS) or rows == 1:
            break
        rows = _cdiv(rows, 2)
    planes = 1
    if rows == height:
        planes = max(1, min(SMEM_TARGET // (4 * floats), THREADS // slots, planes_max))
    if kind == "input_grad":
        runs = _cdiv(w, RUN) if stride == 1 else _cdiv(_cdiv(w, 2), RUN) + _cdiv(w // 2, RUN)
    else:
        runs = _cdiv(wo, RUN)
    most = max(1, THREADS // (planes * slots))
    groups = _cdiv(runs, _cdiv(runs, most))
    threads = min(THREADS, _cdiv(planes * slots * groups, 32) * 32)
    smem = 4 * planes * floats
    if kind == "grad_weight":  # the block's reduction reuses the tiles
        smem = max(smem, 4 * (threads // 32 + 1) * k * k)
    layout = (n, c, h, w, ho, wo, pt, pl, planes, rows, groups, in_rows, in_stride, out_stride,
              cluster)
    return layout, threads, smem


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, x, w=None, dy=None, k=None, stride=1):
    """Raises unless the operands are contiguous non-empty f32 CUDA tensors
    on one device that the kernels take: x (N, C, H, W), w (C, 1, k, k) and
    dy (N, C, ceil(H / s), ceil(W / s)), k in :data:`KERNELS`, s in
    :data:`STRIDES`."""
    ops = [t for t in (x, w, dy) if t is not None]
    if any(t.device.type != "cuda" or t.device != x.device for t in ops):
        raise ValueError(f"{name} kernel needs its operands on one CUDA device; got "
                         f"{[str(t.device) for t in ops]}")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"{name} kernel takes f32 operands, not {[t.dtype for t in ops]}")
    if any(t.ndim != 4 or t.numel() == 0 for t in ops):
        raise ValueError(f"{name} kernel needs non-empty 4-D operands; got "
                         f"{[tuple(t.shape) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name} kernel needs contiguous NCHW operands")
    n, c, h, wd = x.shape
    if w is not None:
        k = w.shape[-1]
        if tuple(w.shape) != (c, 1, k, k):
            raise ValueError(f"{name} kernel: filter {tuple(w.shape)} is not (C, 1, k, k) for "
                             f"x {tuple(x.shape)}")
    if k not in KERNELS or stride not in STRIDES:
        raise ValueError(f"{name} kernel is built for k in {KERNELS} and strides in {STRIDES}; "
                         f"got k = {k}, stride {stride}")
    if dy is not None and tuple(dy.shape) != (n, c, out_size(h, stride), out_size(wd, stride)):
        raise ValueError(f"{name} kernel: dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} at stride {stride}")
    if x.numel() >= 2**31 or (dy is not None and dy.numel() >= 2**31):
        raise ValueError(f"{name} kernel indexes a plane's rows with 32-bit ints")


@functools.lru_cache(maxsize=None)
def _launch_args(kind, n, c, h, w, k, stride, index):
    """:func:`plan`'s launch on CUDA device ``index``, its layout as the C
    array the library takes."""
    layout, threads, smem = plan(kind, n, c, h, w, k, stride, _sms(index))
    if smem > SMEM_MAX:
        raise ValueError(f"depthwise {kind} kernel: a row of {w} px takes {smem} bytes of shared "
                         f"memory, more than the card's {SMEM_MAX}")
    return (ctypes.c_int * 15)(*layout), threads, smem


def _launch(kind, fn, a, b, out, n, c, h, w, k, stride):
    index = out.device.index
    layout, threads, smem = _launch_args(kind, n, c, h, w, k, stride, index)
    # the current stream's handle (torch.cuda.current_stream builds a Stream
    # object a call: some 10 us of the host's time at 660 launches a step)
    code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), layout, k, stride, threads, smem,
              torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        raise RuntimeError(f"depthwise {kind} kernel launch failed: CUDA error {code}")


def _launch_forward(x, w, stride):
    global launches_forward
    _check("depthwise_conv_forward", x, w, stride=stride)
    n, c, h, wd = x.shape
    k = w.shape[-1]
    y = torch.empty((n, c, out_size(h, stride), out_size(wd, stride)), dtype=torch.float32,
                    device=x.device)
    _launch("forward", _kernel().depthwise_conv_forward, x, w, y, n, c, h, wd, k, stride)
    launches_forward += 1
    return y


def _launch_input_grad(dy, w, height, width, stride):
    global launches_input_grad
    n, c = dy.shape[:2]
    dx = torch.empty((n, c, height, width), dtype=torch.float32, device=dy.device)
    _check("depthwise_conv_input_grad", dx, w, dy, stride=stride)
    k = w.shape[-1]
    _launch("input_grad", _kernel().depthwise_conv_input_grad, dy, w, dx, n, c, height, width,
            k, stride)
    launches_input_grad += 1
    return dx


def _launch_grad_weight(x, dy, k, stride):
    global launches_grad_weight
    _check("depthwise_conv_grad_weight", x, dy=dy, k=k, stride=stride)
    n, c, h, wd = x.shape
    dw = torch.empty((c, 1, k, k), dtype=torch.float32, device=x.device)
    _launch("grad_weight", _kernel().depthwise_conv_grad_weight, x, dy, dw, n, c, h, wd, k,
            stride)
    launches_grad_weight += 1
    return dw


# ---------------------------------------------------------------------------
# The custom ops: the kernels for CUDA tensors, the plain versions for CPU ones
# ---------------------------------------------------------------------------


@torch.library.custom_op("semantic_embeddings_torch::depthwise_conv_forward", mutates_args=(),
                         device_types="cpu")
def depthwise_conv_forward(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """y (N, C, ceil(H / s), ceil(W / s)) of x (N, C, H, W) and w (C, 1, k, k)."""
    return _plain_forward(x, w, stride)


@depthwise_conv_forward.register_kernel("cuda")
def _(x, w, stride):
    return _launch_forward(x, w, stride)


@depthwise_conv_forward.register_fake
def _(x, w, stride):
    n, c, h, wd = x.shape
    return x.new_empty((n, c, out_size(h, stride), out_size(wd, stride)))


@torch.library.custom_op("semantic_embeddings_torch::depthwise_conv_input_grad", mutates_args=(),
                         device_types="cpu")
def depthwise_conv_input_grad(dy: torch.Tensor, w: torch.Tensor, height: int, width: int,
                              stride: int) -> torch.Tensor:
    """dx (N, C, height, width) of the conv whose output gradient is dy."""
    return _plain_input_grad(dy, w, height, width, stride)


@depthwise_conv_input_grad.register_kernel("cuda")
def _(dy, w, height, width, stride):
    return _launch_input_grad(dy, w, height, width, stride)


@depthwise_conv_input_grad.register_fake
def _(dy, w, height, width, stride):
    return dy.new_empty((dy.shape[0], dy.shape[1], height, width))


@torch.library.custom_op("semantic_embeddings_torch::depthwise_conv_grad_weight", mutates_args=(),
                         device_types="cpu")
def depthwise_conv_grad_weight(x: torch.Tensor, dy: torch.Tensor, k: int,
                               stride: int) -> torch.Tensor:
    """dw (C, 1, k, k), in f32 (f64 for f64 operands on the CPU)."""
    return _plain_grad_weight(x, dy, k, stride)


@depthwise_conv_grad_weight.register_kernel("cuda")
def _(x, dy, k, stride):
    return _launch_grad_weight(x, dy, k, stride)


@depthwise_conv_grad_weight.register_fake
def _(x, dy, k, stride):
    return x.new_empty((x.shape[1], 1, k, k), dtype=torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# Autograd, and where the op engages
# ---------------------------------------------------------------------------


class DepthwiseConv(torch.autograd.Function):
    """The SAME depthwise conv of x by w at this stride through the three
    ops; it saves x and w, as ATen's path does."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return depthwise_conv_forward(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv_input_grad(g, w, x.shape[2], x.shape[3], ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = depthwise_conv_grad_weight(x, g, w.shape[-1], ctx.stride).to(w.dtype)
        return dx, dw, None


def engages(conv, x):
    """Whether ``conv`` (a ``Conv2dSame``) applied to ``x`` takes the op: a
    depthwise conv (``groups`` = its input and output channels) with a
    square odd filter of :data:`KERNELS`, one stride of :data:`STRIDES`, SAME
    padding, no bias and no dilation, on an f32 contiguous NCHW x and an f32
    weight on a device of :data:`KERNEL_DEVICES`, outside autocast and with
    no spatial grid.  Anything else (every ``groups == 1`` conv, bf16 under
    autocast, ``--spatial``) keeps the module's own call."""
    if conv.groups == 1:
        return False
    w = conv.weight
    return (conv.groups == conv.in_channels == conv.out_channels
            and conv.kernel_size[0] == conv.kernel_size[1] in KERNELS
            and conv.stride[0] == conv.stride[1] in STRIDES
            and conv.bias is None and tuple(conv.dilation) == (1, 1)
            and getattr(conv, "same", False)
            and x.device.type in KERNEL_DEVICES and w.device == x.device
            and x.dtype == torch.float32 and w.dtype == torch.float32
            and x.ndim == 4 and x.is_contiguous() and w.is_contiguous()
            and not torch.is_autocast_enabled(x.device.type)
            and not spatial.active())


def depthwise_conv(conv, x):
    """``conv(x)`` for a depthwise ``Conv2dSame`` where :func:`engages`:
    through :class:`DepthwiseConv`."""
    return DepthwiseConv.apply(x, conv.weight, conv.stride[0])
