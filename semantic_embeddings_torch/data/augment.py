"""On-device image augmentation (counterpart of the JAX package's
``data/augment.py``).  Images are NHWC float tensors in [0, 255].

Each random transform is split in two: a *draw* function takes its
per-image parameters from a ``torch.Generator`` (on the generator's
device), and an *apply* function transforms the batch at those parameters,
so that the same parameters can be fed to both packages.  For the random
affine transform these are :func:`draw_affine_params` and
:func:`affine_apply`.  The apply step is the JAX package's
``_affine_sample`` written out as a gather:
output pixel (y, x) reads input position ``(y - cy) * zy + cy - ty`` (zoom
about the center, then translate; x mirrored before clamping when
flipped), with bilinear interpolation and edge clamping.
"""

from __future__ import annotations

import torch


def _uniform(generator, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo


def draw_affine_params(b, h, w, generator, *, width_shift=0.0,
                       height_shift=0.0, zoom=0.0, hflip=False):
    """Per-image ``(ty, tx, zy, zx, flip)`` for a batch of ``b`` images,
    drawn on the generator's device: shifts uniform in ``±shift * size``,
    zooms uniform in ``[1 - zoom, 1 + zoom]``, flips with probability 0.5."""
    device = generator.device
    zeros = torch.zeros(b, device=device)
    ty = _uniform(generator, (b,), -height_shift, height_shift) * h if height_shift else zeros
    tx = _uniform(generator, (b,), -width_shift, width_shift) * w if width_shift else zeros
    if zoom:
        z = _uniform(generator, (b, 2), 1.0 - zoom, 1.0 + zoom)
        zy, zx = z[:, 0], z[:, 1]
    else:
        zy = zx = torch.ones(b, device=device)
    flip = draw_flips(b, generator) if hflip else torch.zeros(b, dtype=torch.bool, device=device)
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


def rows_of(draws, start, stop):
    """Rows [start, stop) of every tensor in a tree (tuple, list, dict, or
    None) of per-image draws: a process's share of draws made for its whole
    global batch."""
    if draws is None:
        return None
    if isinstance(draws, dict):
        return {k: rows_of(v, start, stop) for k, v in draws.items()}
    if isinstance(draws, (tuple, list)):
        return type(draws)(rows_of(v, start, stop) for v in draws)
    return draws[start:stop]


def random_affine_batch(images, generator, *, width_shift=0.0,
                        height_shift=0.0, zoom=0.0, hflip=False):
    """Keras-style random shift / zoom / flip for a batch (B, H, W, C)."""
    b, h, w, _ = images.shape
    params = draw_affine_params(
        b, h, w, generator, width_shift=width_shift,
        height_shift=height_shift, zoom=zoom, hflip=hflip)
    return affine_apply(images, *params)


def draw_flips(b, generator):
    """Per-image horizontal flips, each with probability 0.5."""
    return _uniform(generator, (b,)) < 0.5


def flip_apply(images, flip):
    """Mirrors the images of (B, H, W, C) whose ``flip`` is set."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_flip(images, generator, horizontal=True, vertical=False):
    """Exact 50% flips without resampling."""
    b = images.shape[0]
    if horizontal:
        images = flip_apply(images, draw_flips(b, generator))
    if vertical:
        f = draw_flips(b, generator)
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


# ---------------------------------------------------------------------------
# The file datasets' transforms: random erasing, color distortion, crops
# ---------------------------------------------------------------------------


def draw_erasing_params(b, h, w, c, generator, *, probability=0.5, sl=0.02,
                        sh=0.4, r1=0.3, r2=1.0 / 0.3, tries=12):
    """Per-image random-erasing draws: ``(apply, area, ratio, uy, ux,
    noise)``: whether to erase (probability ``probability``), ``tries``
    candidate areas in ``[sl, sh] * h * w`` and aspects in ``[r1, r2]``,
    the patch's position as uniforms in [0, 1), and the uniform [0, 255)
    noise that fills it."""
    apply = _uniform(generator, (b,)) < probability
    area = _uniform(generator, (b, tries), sl, sh) * (h * w)
    ratio = _uniform(generator, (b, tries), r1, r2)
    uy = _uniform(generator, (b,))
    ux = _uniform(generator, (b,))
    noise = _uniform(generator, (b, h, w, c), 0.0, 255.0)
    return apply, area, ratio, uy, ux, noise


def erasing_apply(images, mean, std, apply, area, ratio, uy, ux, noise):
    """Random erasing in normalized space at the draws of
    :func:`draw_erasing_params`: each image's patch is the first candidate
    (area, aspect) that fits inside the image (the reference's rejection
    loop with a fixed number of tries), filled with the noise normalized by
    (mean, std)."""
    b, h, w, _ = images.shape
    he_c = torch.sqrt(area * ratio).to(torch.int32)
    we_c = torch.sqrt(area / ratio).to(torch.int32)
    valid = (he_c < h) & (we_c < w)
    # the first valid candidate; if none is valid (vanishing probability),
    # the first, clamped
    tries = torch.arange(valid.shape[1], device=valid.device)
    pick = torch.where(valid, tries, valid.shape[1]).amin(dim=1, keepdim=True)
    pick = torch.where(pick == valid.shape[1], 0, pick)
    he = torch.clamp(torch.gather(he_c, 1, pick)[:, 0], 1, h - 1)
    we = torch.clamp(torch.gather(we_c, 1, pick)[:, 0], 1, w - 1)
    ye = (uy * (h - he)).to(torch.int32)
    xe = (ux * (w - we)).to(torch.int32)
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    fill = (noise - mean) / std
    rows = torch.arange(h, device=images.device)[None, :, None]
    cols = torch.arange(w, device=images.device)[None, None, :]
    in_patch = ((rows >= ye[:, None, None]) & (rows < (ye + he)[:, None, None])
                & (cols >= xe[:, None, None]) & (cols < (xe + we)[:, None, None])
                & apply[:, None, None])
    return torch.where(in_patch[..., None], fill, images)


def random_erasing(images, generator, mean, std, *, probability=0.5, sl=0.02,
                   sh=0.4, r1=0.3, r2=1.0 / 0.3):
    """Random erasing (Zhong et al.) of a normalized batch (B, H, W, C)."""
    b, h, w, c = images.shape
    draws = draw_erasing_params(b, h, w, c, generator, probability=probability,
                                sl=sl, sh=sh, r1=r1, r2=r2)
    return erasing_apply(images, mean, std, *draws)


def rgb_to_hsv(rgb):
    """Channels-last RGB [0,1] -> HSV [0,1] (matplotlib convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-20), 0.0)
    safe = torch.clamp_min(delta, 1e-20)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv):
    """Channels-last HSV [0,1] -> RGB [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*values):  # values[k] where i == k
        out = values[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def draw_color_params(b, generator, *, fast_mode=True,
                      brightness_delta=32.0 / 255.0, hue_delta=0.2,
                      saturation_range=(0.5, 1.5), contrast_range=(0.5, 1.5)):
    """Per-image color-distortion draws: brightness, saturation and, in full
    mode, hue, per-channel contrast (B, 3) and one of the four orderings;
    the full-mode draws are None in fast mode."""
    bright = _uniform(generator, (b,), -brightness_delta, brightness_delta)
    sat = _uniform(generator, (b,), *saturation_range)
    if fast_mode:
        return {"bright": bright, "sat": sat, "hue": None, "contrast": None,
                "order": None}
    return {"bright": bright, "sat": sat,
            "hue": _uniform(generator, (b,), -hue_delta, hue_delta),
            "contrast": _uniform(generator, (b, 3), *contrast_range),
            "order": torch.randint(0, 4, (b,), generator=generator,
                                   device=generator.device)}


def distort_color_apply(images, bright, sat, hue=None, contrast=None, order=None):
    """Color distortion of [0, 255] images at the draws of
    :func:`draw_color_params`.  Fast mode (``hue`` None) perturbs brightness
    (HSV value) and saturation, which act on disjoint HSV channels, so one
    combined application is exact.  Full mode applies brightness / hue /
    saturation / contrast in each image's one of the reference's four
    orderings (each ordering runs on the whole batch and the image takes
    its own: no host round trip)."""
    x = images / 255.0
    br = bright[:, None, None]
    st = sat[:, None, None]
    if hue is None:
        hsv = rgb_to_hsv(x)
        s = torch.clamp(hsv[..., 1] * st, 0.0, 1.0)
        v = torch.clamp(hsv[..., 2] + br, 0.0, 1.0)
        return hsv_to_rgb(torch.stack([hsv[..., 0], s, v], dim=-1)) * 255.0
    hu = hue[:, None, None]
    cf = contrast[:, None, None, :]

    def brightness_fn(y):
        return torch.clamp(y + br[..., None], 0.0, 1.0)

    def hue_sat_fn(y, do_bright_hsv=False):
        hsv = rgb_to_hsv(y)
        h = torch.remainder(hsv[..., 0] + hu, 1.0)
        s = torch.clamp(hsv[..., 1] * st, 0.0, 1.0)
        v = hsv[..., 2]
        if do_bright_hsv:
            v = torch.clamp(v + br, 0.0, 1.0)
        return hsv_to_rgb(torch.stack([h, s, v], dim=-1))

    def contrast_fn(y):
        mean = y.mean(dim=(1, 2), keepdim=True)
        return torch.clamp((y - mean) * cf + mean, 0.0, 1.0)

    def sat_fn(y):
        hsv = rgb_to_hsv(y)
        s = torch.clamp(hsv[..., 1] * st, 0.0, 1.0)
        return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))

    def hue_fn(y):
        hsv = rgb_to_hsv(y)
        h = torch.remainder(hsv[..., 0] + hu, 1.0)
        return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))

    branches = [
        # the reference's orderings, ops on disjoint HSV channels merged
        # into one round trip:
        # 0: brightness -> sat -> hue -> contrast
        lambda y: contrast_fn(hue_sat_fn(brightness_fn(y))),
        # 1: sat first -> brightness -> contrast -> hue
        lambda y: hue_fn(contrast_fn(brightness_fn(sat_fn(y)))),
        # 2: contrast -> hue -> brightness (HSV value) -> sat
        lambda y: hue_sat_fn(contrast_fn(y), do_bright_hsv=True),
        # 3: hue -> sat -> contrast -> brightness
        lambda y: brightness_fn(contrast_fn(hue_sat_fn(y))),
    ]
    out = x
    for k, branch in enumerate(branches):
        out = torch.where((order == k)[:, None, None, None], branch(x), out)
    return out * 255.0


def distort_color(images, generator, fast_mode=True, **params):
    """Random color distortion of a [0, 255] batch (B, H, W, 3)."""
    draws = draw_color_params(images.shape[0], generator, fast_mode=fast_mode, **params)
    return distort_color_apply(images, **draws)


def draw_crop_params(b, generator):
    """Per-image crop positions as uniforms in [0, 1): ``(uy, ux)``."""
    return _uniform(generator, (b,)), _uniform(generator, (b,))


def crop_apply(images, uy, ux, crop_h, crop_w):
    """Crops each image of (B, H, W, C) at offsets ``uy * (H - crop_h + 1)``
    and ``ux * (W - crop_w + 1)`` (rounded down); inputs are at least the
    crop size."""
    b, h, w, _ = images.shape
    oy = (uy * (h - crop_h + 1)).long()
    ox = (ux * (w - crop_w + 1)).long()
    rows = oy[:, None] + torch.arange(crop_h, device=images.device)[None, :]
    cols = ox[:, None] + torch.arange(crop_w, device=images.device)[None, :]
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images[bi, rows[:, :, None], cols[:, None, :]]


def random_crop_batch(images, generator, crop_h, crop_w):
    """Random crop with one output shape for the batch."""
    return crop_apply(images, *draw_crop_params(images.shape[0], generator),
                      crop_h, crop_w)


def center_crop_batch(images, crop_h, crop_w):
    _, h, w, _ = images.shape
    oy, ox = (h - crop_h) // 2, (w - crop_w) // 2
    return images[:, oy:oy + crop_h, ox:ox + crop_w, :]
