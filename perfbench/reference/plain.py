"""Plain PyTorch pieces of the reference training step.

The reference is written from the published recipe, not from the program:
TF "SAME" convolutions, Keras BatchNorm (momentum 0.99, the running
variance moved towards the biased batch variance), the L2-normalized
embedding under the cosine loss, the 0.1-weight softmax head with Keras's
clipped cross-entropy, the Keras L2 kernel penalty, per-tensor clipping to
norm 10 and Keras SGD with momentum 0.9 (``v <- 0.9 v - lr g; p <- p + v``).
It imports nothing of the program and nothing of JAX.

A model is a pair of dicts: ``params`` (leaf tensors that take gradients)
and ``stats`` (BatchNorm running statistics), keyed by the names of the
program's ``state_dict``, so that one set of weights made by the benchmark
loads into both.  Every layer runs through an :class:`Ops` object, which
sets the precision of the products (the control computes them in a lower
one) and which :class:`Recorder` replaces to count operations from shapes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

KERAS_EPS = 1e-7  # Keras's clip of the probabilities in the cross-entropy
NORM_EPS = 1e-12  # tf.nn.l2_normalize's epsilon on the squared norm


# ---------------------------------------------------------------------------
# Precisions of the products (convolutions and dense layers)
# ---------------------------------------------------------------------------


def _identity(x):
    return x


def round_tf32(x):
    """f32 -> TF32 (10 explicit mantissa bits), rounded to nearest with ties
    away from zero, as the tensor cores convert their f32 operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def _fp8(dtype):
    top = torch.finfo(dtype).max

    def quantize(x):
        # one scale a tensor, its largest magnitude onto fp8's largest value
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = amax / top
        return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)

    return quantize


class _StoreFP8(torch.autograd.Function):
    """Rounds an activation to e4m3 with a per-tensor scale, as an fp8
    network stores it; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _E4M3(x)

    @staticmethod
    def backward(ctx, g):
        return g


_E4M3 = _fp8(torch.float8_e4m3fn)

#: name -> (rounding of the products' forward operands, of the products'
#: incoming gradient, of the activations the layers store)
PRECISIONS = {
    "f32": (_identity, _identity, _identity),
    # TF32 tensor cores: both operands of every product rounded to TF32
    "tf32": (round_tf32, round_tf32, _identity),
    # an fp8 network where the program's is bf16: e4m3 weights and
    # activations and e5m2 gradients into the products, the layers' outputs
    # stored in e4m3, each tensor with its own scale (BatchNorm's and the
    # loss's sums in f32)
    "fp8": (_E4M3, _fp8(torch.float8_e5m2), _StoreFP8.apply),
}


class _Conv(torch.autograd.Function):
    """``F.conv2d`` whose operands are rounded to a precision, forward and
    backward (each product of dx and dw takes rounded operands)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, fwd, bwd):
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, bwd)
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, bwd = ctx.conf
        gq = bwd(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding)
        return dx, dw, None, None, None, None


class _Linear(torch.autograd.Function):
    """``x @ w.T`` with operands rounded to a precision, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w, fwd, bwd):
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.bwd = bwd
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.bwd(g)
        return gq @ wq, gq.T @ xq, None, None


def same_pads(size, kernel, stride):
    """TF SAME padding (before, after) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Ops:
    """The layers of a reference model, in the precision ``precision`` (a
    key of :data:`PRECISIONS`) for the convolutions and dense layers; every
    other operation runs in f32."""

    def __init__(self, precision="f32"):
        self.fwd, self.bwd, self.store = PRECISIONS[precision]

    def conv(self, name, x, w, stride=1, padding="SAME"):
        """A bias-free convolution of NCHW ``x`` with (F, C, k, k) ``w``:
        TF SAME padding, or the explicit (left, right, top, bottom) pads."""
        k = w.shape[-1]
        if padding == "SAME":
            top, bottom = same_pads(x.shape[2], k, stride)
            left, right = same_pads(x.shape[3], k, stride)
        else:
            left, right, top, bottom = padding
        if (left, top) != (right, bottom):
            x = F.pad(x, (left, right, top, bottom))
            left = top = 0
        return self.store(_Conv.apply(x, w, stride, (top, left), self.fwd, self.bwd))

    def dense(self, name, x, w, b):
        return self.store(_Linear.apply(x, w, self.fwd, self.bwd) + b)

    def batch_norm(self, name, x, params, stats, momentum=0.99, eps=1e-3):
        """Training BatchNorm over every axis but 1, normalized by the batch's
        mean and biased variance; the running statistics in ``stats`` move
        towards them (Keras)."""
        dims = [0] + list(range(2, x.ndim))
        with torch.no_grad():
            mean, var = x.mean(dims), x.var(dims, correction=0)
            key_mean, key_var = name + ".running_mean", name + ".running_var"
            stats[key_mean] = stats[key_mean] * momentum + mean * (1 - momentum)
            stats[key_var] = stats[key_var] * momentum + var * (1 - momentum)
        y = F.batch_norm(x, None, None, params[name + ".weight"], params[name + ".bias"],
                         True, 0.0, eps)
        return self.store(y)

    def relu(self, x):
        return torch.relu(x)

    def pad(self, x, n):
        return F.pad(x, (n, n, n, n))

    def pad_channels(self, x, before, after):
        return F.pad(x, (0, 0, 0, 0, before, after))

    def max_pool(self, x, window, stride):
        return F.max_pool2d(x, window, stride)

    def avg_pool(self, x, window):
        return F.avg_pool2d(x, window, window)

    def global_avg_pool(self, x):
        return x.mean(dim=(2, 3))

    def add(self, a, b):
        return self.store(a + b)


# ---------------------------------------------------------------------------
# The heads, the losses and the update
# ---------------------------------------------------------------------------


def l2_normalize(z):
    return z * torch.rsqrt(torch.clamp_min((z * z).sum(-1, keepdim=True), NORM_EPS))


def heads_loss(ops, z, params, stats, targets, labels, cls_weight):
    """The training loss of a raw embedding ``z`` (B, d): the cosine loss
    ``1 - <t, z / |z|>`` against the target rows, plus ``cls_weight`` times
    Keras's cross-entropy of the softmax head relu -> BN -> dense on the
    normalized embedding.  Returns the batch means (total, cosine, ce)."""
    zn = l2_normalize(z)
    cos = (1.0 - (targets * zn).sum(-1)).mean()
    h = ops.batch_norm("cls_bn", ops.relu(zn), params, stats)
    logits = ops.dense("cls_top", h, params["cls_top.weight"], params["cls_top.bias"])
    prob = torch.softmax(logits, dim=-1)
    prob = torch.clamp(prob, KERAS_EPS, 1.0 - KERAS_EPS)
    prob = prob / prob.sum(-1, keepdim=True)
    onehot = F.one_hot(labels, prob.shape[-1]).to(prob.dtype)
    ce = -(onehot * torch.log(prob)).sum(-1).mean()
    return cos + cls_weight * ce, cos, ce


def l2_penalty(params, rules):
    """Keras kernel regularization: for each conv or dense kernel (a
    ``weight`` of two or four dimensions) the coefficient of the first rule
    whose pattern matches its layer's name, times its squared norm."""
    import re

    total = 0.0
    for name, p in params.items():
        if not name.endswith(".weight") or p.ndim not in (2, 4):
            continue
        layer = name[: -len(".weight")].replace(".", "/")
        for pattern, coef in rules:
            if re.search(pattern, layer):
                total = total + coef * (p * p).sum()
                break
    return total


@torch.no_grad()
def sgd_update(params, velocity, grads, lr, momentum=0.9, clipnorm=10.0):
    """Keras SGD: each gradient clipped to norm ``clipnorm`` on its own,
    ``v <- momentum v - lr g``, ``p <- p + v``.  Returns the clipped
    gradients."""
    clipped = {}
    for name, g in grads.items():
        norm = torch.linalg.vector_norm(g)
        g = g * (clipnorm / torch.clamp_min(norm, clipnorm))
        clipped[name] = g
        velocity[name] = velocity[name] * momentum - lr * g
        params[name].add_(velocity[name])
    return clipped


def train_step(arch, ops, params, stats, velocity, images, labels, table, lr, recipe,
               rows=None):
    """One reference training step, in place on ``params``, ``stats`` and
    ``velocity``, of normalized NHWC ``images`` with int64 ``labels``
    (``rows``: a slice of the batch that alone is trained on, the others
    left out).  ``arch`` is a reference module (its ``forward``),
    ``recipe`` the configuration's dict.  Returns the total loss and the
    clipped gradients as the update took them."""
    if rows is not None:
        images, labels = images[rows], labels[rows]
    z = arch.forward(ops, params, stats, images.permute(0, 3, 1, 2), recipe)
    total, _, _ = heads_loss(ops, z, params, stats, table[labels], labels,
                             recipe["cls_weight"])
    total = total + l2_penalty(params, recipe["l2"])
    names = list(params)
    grads = torch.autograd.grad(total, [params[n] for n in names])
    clipped = sgd_update(params, velocity, dict(zip(names, grads)), lr,
                         recipe["momentum"], recipe["clipnorm"])
    return total.detach(), clipped


def sgdr_lr(step, steps_per_epoch, max_lr, base_len, mul, decay, min_lr=1e-6):
    """The learning rate of global step ``step`` (from 0): SGDR's cosine with
    warm restarts by epoch (the first epoch of a cycle at ``max_lr``),
    divided by ``1 + decay * step`` (Keras's time decay)."""
    epoch, length = step // steps_per_epoch, base_len
    while epoch >= length:
        epoch -= length
        length *= mul
    lr = max_lr if epoch == 0 else min_lr + 0.5 * (max_lr - min_lr) * (
        1 + math.cos(math.pi * (epoch + 1) / length))
    return lr / (1.0 + decay * step) if decay else lr


# ---------------------------------------------------------------------------
# The input pipeline: normalization and the random shift and flip
# ---------------------------------------------------------------------------


def channel_moments(images):
    """Per-channel mean and population standard deviation of uint8 NHWC
    images over the whole set, in f64 (Keras's featurewise statistics)."""
    x = images.reshape(-1, images.shape[-1])
    total = torch.zeros(x.shape[-1], dtype=torch.float64, device=x.device)
    sq = torch.zeros_like(total)
    for rows in x.split(1 << 24):
        r = rows.double()
        total += r.sum(0)
        sq += (r * r).sum(0)
    n = x.shape[0]
    mean = total / n
    return mean.float(), torch.sqrt(sq / n - mean * mean).float()


def shift_flip(images, generator, height_shift, width_shift, hflip):
    """The random shift and flip of a float NHWC batch: per image a shift
    uniform in +-``shift`` of the size (drawn height first, then width) and
    a flip with probability 1/2, drawn from ``generator`` in that order;
    each output pixel (y, x) takes the bilinear value at (y - ty, x - tx),
    x mirrored first where the image flips, edges clamped."""
    b, h, w, _ = images.shape
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand((b,), generator=generator, device=dev) * (hi - lo) + lo

    ty = uniform(-height_shift, height_shift) * h if height_shift else torch.zeros(b, device=dev)
    tx = uniform(-width_shift, width_shift) * w if width_shift else torch.zeros(b, device=dev)
    flip = uniform(0.0, 1.0) < 0.5 if hflip else torch.zeros(b, dtype=torch.bool, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :] - ty[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :] - tx[:, None]
    xs = torch.where(flip[:, None], (w - 1) - xs, xs)
    # grid_sample's border padding clamps the sample points to the edge
    gy = (2.0 * ys / (h - 1) - 1.0)[:, :, None].expand(b, h, w)
    gx = (2.0 * xs / (w - 1) - 1.0)[:, None, :].expand(b, h, w)
    grid = torch.stack([gx, gy], dim=-1).to(images.dtype)
    out = F.grid_sample(images.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)
