"""On-device image augmentation (counterpart of the JAX package's
``data/augment.py``).  Images are NHWC float tensors in [0, 255].

The random affine transform is split in two: :func:`draw_affine_params`
draws each image's translation, zoom and flip from a ``torch.Generator``,
and :func:`affine_apply` resamples the batch at those parameters.  The
apply step is the JAX package's ``_affine_sample`` written out as a gather:
output pixel (y, x) reads input position ``(y - cy) * zy + cy - ty`` (zoom
about the center, then translate; x mirrored before clamping when
flipped), with bilinear interpolation and edge clamping.
"""

from __future__ import annotations

import torch


def draw_affine_params(b, h, w, generator, *, width_shift=0.0,
                       height_shift=0.0, zoom=0.0, hflip=False):
    """Per-image ``(ty, tx, zy, zx, flip)`` for a batch of ``b`` images,
    drawn on the generator's device: shifts uniform in ``±shift * size``,
    zooms uniform in ``[1 - zoom, 1 + zoom]``, flips with probability 0.5."""
    device = generator.device

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    zeros = torch.zeros(b, device=device)
    ty = uniform(-height_shift, height_shift, (b,)) * h if height_shift else zeros
    tx = uniform(-width_shift, width_shift, (b,)) * w if width_shift else zeros
    if zoom:
        z = uniform(1.0 - zoom, 1.0 + zoom, (b, 2))
        zy, zx = z[:, 0], z[:, 1]
    else:
        zy = zx = torch.ones(b, device=device)
    flip = (torch.rand(b, generator=generator, device=device) < 0.5
            if hflip else torch.zeros(b, dtype=torch.bool, device=device))
    return ty, tx, zy, zx, flip


def affine_apply(images, ty, tx, zy, zx, flip):
    """Resamples (B, H, W, C) images at per-image translation ``ty``/``tx``,
    zoom ``zy``/``zx`` and horizontal ``flip`` (each of shape (B,))."""
    b, h, w, _ = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ar_h = torch.arange(h, dtype=torch.float32, device=images.device)
    ar_w = torch.arange(w, dtype=torch.float32, device=images.device)
    ys = (ar_h[None, :] - cy) * zy[:, None] + cy - ty[:, None]  # (B, H)
    xs = (ar_w[None, :] - cx) * zx[:, None] + cx - tx[:, None]  # (B, W)
    xs = torch.where(flip[:, None], (w - 1) - xs, xs)
    ys = torch.clamp(ys, 0.0, h - 1)
    xs = torch.clamp(xs, 0.0, w - 1)

    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]

    bi = torch.arange(b, device=images.device)[:, None, None]

    def gather(yi, xi):
        return images[bi, yi[:, :, None], xi[:, None, :]]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def random_affine_batch(images, generator, *, width_shift=0.0,
                        height_shift=0.0, zoom=0.0, hflip=False):
    """Keras-style random shift / zoom / flip for a batch (B, H, W, C)."""
    b, h, w, _ = images.shape
    params = draw_affine_params(
        b, h, w, generator, width_shift=width_shift,
        height_shift=height_shift, zoom=zoom, hflip=hflip)
    return affine_apply(images, *params)


def random_flip(images, generator, horizontal=True, vertical=False):
    """Exact 50% flips without resampling."""
    b = images.shape[0]
    device = images.device
    if horizontal:
        f = torch.rand(b, generator=generator, device=device) < 0.5
        images = torch.where(f[:, None, None, None], images.flip(2), images)
    if vertical:
        f = torch.rand(b, generator=generator, device=device) < 0.5
        images = torch.where(f[:, None, None, None], images.flip(1), images)
    return images


def normalize(images, mean, std, bgr=False):
    """(x - mean) / std with RGB stats; optional RGB->BGR reorder afterwards."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    out = (images - mean) / std
    if bgr:
        out = out.flip(-1)
    return out
