"""Fused L2-normalize + dot cosine loss: a CUDA kernel pair and its plain version.

Counterpart of ``semantic_embeddings_tpu/ops/cosine_loss.py``.  Per row:

  forward:  nsq = max(||z||^2, eps); loss = 1 - (t . z) * rsqrt(nsq)
  backward: dz = -g * rsqrt(nsq) * (t - ((t . z) / nsq) * z)

Forward and backward are ``torch.library`` custom ops,
``semantic_embeddings_torch::cosine_loss_fwd`` and ``::cosine_loss_bwd``, the
second registered as the autograd of the first, each with a fake
implementation, so that graphs through them trace and export.  For a CUDA
tensor each op launches one hand-written kernel (``csrc/cosine_loss.cu``,
built by :mod:`.._build` at first use), or raises.  For a CPU tensor they
run :func:`_plain_forward` / :func:`_plain_backward`, the torch
transcription of the JAX package's ``_jnp_forward`` and ``_bwd``.  The
dispatcher picks by the tensor's device, nothing else: there is no fallback
from the kernel to the plain version.

``launches_fwd`` / ``launches_bwd`` count kernel launches, so that a run can
show that its train steps went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

_EPS = 1e-12  # tf.nn.l2_normalize epsilon

#: kernel launches since the process started (or since a caller reset them)
launches_fwd = 0
launches_bwd = 0

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("cosine_loss")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cosine_loss_forward.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
        lib.cosine_loss_forward.restype = i32
        lib.cosine_loss_backward.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
        lib.cosine_loss_backward.restype = i32
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the reference the kernels are held against)
# ---------------------------------------------------------------------------


def _upcast(z):
    """bf16 -> f32, f32 -> f32, f64 -> f64."""
    return z.to(torch.promote_types(z.dtype, torch.float32))


def _plain_forward(z, t):
    zf = _upcast(z)
    tf = t.to(zf.dtype)
    nsq = torch.clamp_min(torch.sum(zf * zf, dim=1), _EPS)
    dot = torch.sum(tf * zf, dim=1)
    return 1.0 - dot * torch.rsqrt(nsq)


def _plain_backward(z, t, g):
    zf = _upcast(z)
    tf = t.to(zf.dtype)
    nsq = torch.clamp_min(torch.sum(zf * zf, dim=1), _EPS)
    dot = torch.sum(tf * zf, dim=1)
    inv_n = torch.rsqrt(nsq)
    dz = (-g.to(zf.dtype) * inv_n)[:, None] * (tf - (dot / nsq)[:, None] * zf)
    return dz.to(z.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_shapes(z, t):
    """The fake implementations' check: z and t 2-D of one shape, through
    ``torch._check``, which takes a symbolic batch."""
    if z.ndim != 2 or t.ndim != 2:
        raise ValueError(
            f"cosine loss needs 2-D z and t; got {tuple(z.shape)} and {tuple(t.shape)}")
    torch._check(z.shape[0] == t.shape[0] and z.shape[1] == t.shape[1],
                 lambda: f"cosine loss needs z and t of one shape; got "
                         f"{tuple(z.shape)} and {tuple(t.shape)}")


def _check(z, t):
    if z.device.type != "cuda" or t.device != z.device:
        raise ValueError(
            f"cosine-loss kernel needs z and t on one CUDA device; got "
            f"{z.device} and {t.device}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cosine-loss kernel takes f32 or bf16 z, not {z.dtype}")
    if z.ndim != 2 or tuple(t.shape) != tuple(z.shape):
        raise ValueError(
            f"cosine-loss kernel needs 2-D z and t of one shape; got "
            f"{tuple(z.shape)} and {tuple(t.shape)}")
    if z.shape[0] < 1 or z.shape[1] < 1:
        raise ValueError(f"cosine-loss kernel needs B, D >= 1; got {tuple(z.shape)}")
    if not z.is_contiguous():
        raise ValueError("cosine-loss kernel needs a contiguous z")
    # t is the class-embedding gather, kept in f32 (it gets no gradient).
    return t.float().contiguous()


def _raise_on(code, what):
    if code != 0:
        raise RuntimeError(
            f"cosine-loss {what} kernel launch failed: CUDA error {code}")


def _launch_forward(z, t):
    global launches_fwd
    t = _check(z, t)
    b, d = z.shape
    loss = torch.empty(b, dtype=torch.float32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    code = _kernels().cosine_loss_forward(
        z.data_ptr(), t.data_ptr(), loss.data_ptr(), b, d,
        int(z.dtype == torch.bfloat16), stream)
    _raise_on(code, "forward")
    launches_fwd += 1
    return loss


def _launch_backward(z, t, g):
    global launches_bwd
    t = _check(z, t)
    b, d = z.shape
    # autograd hands the backward of .mean() an expanded, stride-0 g
    g = g.float().contiguous()
    if tuple(g.shape) != (b,) or g.device != z.device:
        raise ValueError(f"cosine-loss backward needs g of shape ({b},) on {z.device}")
    dz = torch.empty_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    code = _kernels().cosine_loss_backward(
        z.data_ptr(), t.data_ptr(), g.data_ptr(), dz.data_ptr(), b, d,
        int(z.dtype == torch.bfloat16), stream)
    _raise_on(code, "backward")
    launches_bwd += 1
    return dz


# ---------------------------------------------------------------------------
# The custom ops: the kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------


@torch.library.custom_op("semantic_embeddings_torch::cosine_loss_fwd",
                         mutates_args=(), device_types="cpu")
def cosine_loss_fwd(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-row ``1 - <t, z/||z||>``; f32 (f64 for f64 z on the CPU)."""
    return _plain_forward(z, t)


@cosine_loss_fwd.register_kernel("cuda")
def _(z, t):
    return _launch_forward(z, t)


@cosine_loss_fwd.register_fake
def _(z, t):
    _check_shapes(z, t)
    return z.new_empty(z.shape[:1], dtype=torch.promote_types(z.dtype, torch.float32))


@torch.library.custom_op("semantic_embeddings_torch::cosine_loss_bwd",
                         mutates_args=(), device_types="cpu")
def cosine_loss_bwd(z: torch.Tensor, t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dz of :func:`cosine_loss_fwd` for the cotangent g (B,), in z's dtype."""
    return _plain_backward(z, t, g)


@cosine_loss_bwd.register_kernel("cuda")
def _(z, t, g):
    return _launch_backward(z, t, g)


@cosine_loss_bwd.register_fake
def _(z, t, g):
    _check_shapes(z, t)
    return torch.empty_like(z, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    z, t = inputs
    ctx.save_for_backward(z, t)


def _autograd_backward(ctx, g):
    z, t = ctx.saved_tensors
    return cosine_loss_bwd(z, t, g), None


cosine_loss_fwd.register_autograd(_autograd_backward, setup_context=_setup_context)


def fused_cosine_loss(z, t):
    """Per-sample ``1 - <t, z/||z||>`` with a fused backward, through the
    custom op ``semantic_embeddings_torch::cosine_loss_fwd``.

    ``z``: raw (un-normalized) embeddings (B, D), f32 or bf16; ``t``: target
    class embeddings (B, D), treated as constants (no gradient).
    """
    return cosine_loss_fwd(z, t)


def l2_normalize(x, epsilon=_EPS):
    """Plain normalized output (inference/feature path)."""
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, epsilon))


# ---------------------------------------------------------------------------
# Holding the kernels against the plain versions (on the card)
# ---------------------------------------------------------------------------

#: (shape, leading all-zero rows of z) at which the kernels are checked: the
#: train path's (B, D) = (100, 100), a ragged B, a larger tile, and rows
#: whose norm is clamped to eps
CHECK_CASES = [((100, 100), 0), ((37, 100), 0), ((256, 512), 0), ((4, 16), 2)]

#: Tolerances of a kernel's result against the plain version on the same
#: inputs.  f32: both compute the same f32 sums in another order (a warp
#: tree against torch's reductions), so the loss agrees to a few ulp of 1
#: and dz to a few ulp of its size.  bf16 z: the loss is still an f32 sum;
#: both round dz to bf16, one ulp of which is 2**-8 relative.
CHECK_TOL = {
    torch.float32: dict(loss=dict(rtol=0.0, atol=1e-6),
                        dz=dict(rtol=1e-5, atol=1e-7)),
    torch.bfloat16: dict(loss=dict(rtol=0.0, atol=1e-6),
                         dz=dict(rtol=1e-2, atol=1e-3)),
}


def check_inputs(shape, dtype, generator, zero_rows=0):
    """``(z, t, g)`` on ``generator``'s device: z of 3 * N(0, 1) in ``dtype``
    with its first ``zero_rows`` rows zero, t of unit f32 rows, g in [0, 1)."""
    device = generator.device
    z = (torch.randn(shape, generator=generator, device=device) * 3.0).to(dtype)
    z[:zero_rows] = 0
    t = torch.randn(shape, generator=generator, device=device)
    t = t / torch.sqrt(torch.sum(t * t, dim=1, keepdim=True))
    g = torch.rand(shape[0], generator=generator, device=device)
    return z, t, g


def check_against_plain(z, t, g):
    """Launches both kernels on CUDA tensors, synchronizing after each, and
    asserts their results equal the plain versions' within
    :data:`CHECK_TOL`; returns the max |error| of the loss and of dz."""
    loss = _launch_forward(z, t)
    torch.cuda.synchronize()
    dz = _launch_backward(z, t, g)
    torch.cuda.synchronize()
    if dz.dtype != z.dtype or dz.shape != z.shape:
        raise AssertionError(f"dz is {dz.dtype} {tuple(dz.shape)}, z {z.dtype} "
                             f"{tuple(z.shape)}")
    loss_p, dz_p = _plain_forward(z, t), _plain_backward(z, t, g).float()
    tol = CHECK_TOL[z.dtype]
    torch.testing.assert_close(loss, loss_p, **tol["loss"])
    torch.testing.assert_close(dz.float(), dz_p, **tol["dz"])
    return ((loss - loss_p).abs().max().item(),
            (dz.float() - dz_p).abs().max().item())


class PlainCosineLoss(torch.autograd.Function):
    """The custom op's autograd through the plain versions on any device:
    the reference that a train step through the kernels is held against.
    Nothing on the training path uses it."""

    @staticmethod
    def forward(ctx, z, t):
        ctx.save_for_backward(z, t)
        return _plain_forward(z, t)

    @staticmethod
    def backward(ctx, g):
        z, t = ctx.saved_tensors
        return _plain_backward(z, t, g), None
