"""The port's fused 3x3 conv + BN statistics op and its filter gradient
against the JAX package's prototypes and BatchNorm.

On the CPU the port runs the plain versions; they are held against the
Pallas kernels of ``tools/fused_conv_bn_prototype.py`` and
``tools/conv_filter_grad_prototype.py`` run in interpret mode.  The
autograd op (conv + statistics -> ``KerasBatchNorm.forward_from_stats``)
is held against autograd through a plain conv + BN and against ``jax.grad``
of the JAX conv + ``KerasBatchNorm``.  The CUDA kernels are held against
the plain versions on the card in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semantic_embeddings_tpu.models.layers import KerasBatchNorm as JKerasBatchNorm
from semantic_embeddings_torch.models.layers import KerasBatchNorm
from semantic_embeddings_torch.ops import conv3x3 as tc
from tools.conv_filter_grad_prototype import conv3x3_filter_grad as j_filter_grad
from tools.fused_conv_bn_prototype import conv3x3_bn_stats as j_conv_bn_stats


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _conv_inputs(b, h, w, c, f, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, c, f)).astype(np.float32)
    return x, k


# bf16: both sides round f32 sums of exact bf16 products to bf16; sums a
# few f32 ulp apart round apart where they straddle a rounding boundary, so
# y agrees to one bf16 ulp (2**-7 relative) and the statistics of y by the
# effect of such ulps on a sum of 2-3 hundred terms.
CONV_TOL = {
    "f32": dict(y=dict(rtol=0, atol=5e-6), s=dict(rtol=1e-5, atol=1e-4),
                ss=dict(rtol=1e-5, atol=1e-3)),
    "bf16": dict(y=dict(rtol=2**-7, atol=1e-6), s=dict(rtol=1e-3, atol=3e-2),
                 ss=dict(rtol=1e-3, atol=3e-2)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 8), (3, 7, 7, 5, 10)])
def test_plain_conv_bn_stats_matches_pallas_prototype(shape, dtype):
    """The shape of tests/test_ops.py's prototype test, and a ragged one."""
    x, k = _conv_inputs(*shape)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    y_r, s_r, ss_r = j_conv_bn_stats(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                                     interpret=True)
    y, s, ss = tc._plain_conv_bn_stats(_nchw(x).to(tdt), _oihw(k).to(tdt))
    assert y.dtype == tdt and s.dtype == ss.dtype == torch.float32
    tol = CONV_TOL[dtype]
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_r, np.float32), **tol["y"])
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), **tol["s"])
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_r), **tol["ss"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_filter_grad_matches_pallas_prototype(dtype):
    """N = 8 divides the prototype's batch tile (4); the port needs no such
    divisibility.  f32: sums of 512 products in two orders.  bf16: the
    prototype keeps dw in f32, the plain version rounds it to bf16 as the
    prototype's own reference does (2**-8 relative)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8, 8, 4)).astype(np.float32)
    dy = rng.normal(size=(8, 8, 8, 6)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = j_filter_grad(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), batch_tile=4,
                        interpret=True)
    got = tc._plain_filter_grad(_nchw(x).to(tdt), _nchw(dy).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (6, 4, 3, 3)
    tol = dict(rtol=0, atol=1e-4) if dtype == "f32" else dict(rtol=2**-8, atol=1e-3)
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), np.asarray(ref), **tol)


def _wgmma_filter_grad_model(x, dy, top=None, bottom=None, chunk=2):
    """dw as the bf16 ``wgmma`` instance computes it, in numpy: pipeline
    steps of 64 pixels of one image; dy's tile masked per kw (kw = 0 without
    the pixels of the image's left column, kw = 2 without its right one);
    x's pixel rows of the step (for each kh a window of 80 from plane pixel
    p0 + (kh - 1) W - 1 rounded down to 8 pixels; zeros, or the halo rows,
    outside the plane) transposed to [c / 8][row][8] with C padded to whole
    groups, every tap read at its whole-row offset; nine f32 products (F x
    16 pixels x C) a 16-pixel slice, slices past the plane skipped; blocks of
    ``chunk`` steps summed in f32, then the splits added in order in f32."""
    n_img, c_in, h, w = x.shape
    f_out = dy.shape[1]
    hw, step, win, vec = h * w, 64, 80, 8  # 16-byte copies (or the repack)
    cp = -(-c_in // 8) * 8
    per_image = -(-hw // step)
    total = n_img * per_image

    def halo(t):
        return np.zeros((n_img, c_in, w), np.float32) if t is None else t[:, :, 0]

    # each plane with its row -1 before it and row H after it, zeros beyond
    ext = np.zeros((n_img, cp, hw + 2 * w), np.float32)
    ext[:, :c_in] = np.concatenate([halo(top), x.reshape(n_img, c_in, hw), halo(bottom)], axis=2)
    dw = np.zeros((9, f_out, cp), np.float32)
    for t0 in range(0, total, chunk):
        acc = np.zeros((9, f_out, cp), np.float32)
        for t in range(t0, min(t0 + chunk, total)):
            n, p0 = t // per_image, t % per_image * step
            pix = p0 + np.arange(step)
            d = np.zeros((f_out, step), np.float32)
            d[:, pix < hw] = dy[n].reshape(f_out, hw)[:, pix[pix < hw]]
            col = pix % w
            masked = (d * (col >= 1), d, d * (col <= w - 2))
            # the plane pixel of each row, and the row of (pixel 0, kh, kw = 0)
            firsts = [p0 + (kh - 1) * w - 1 for kh in range(3)]
            idx = np.concatenate([f - f % vec + np.arange(win) for f in firsts])
            row0 = [kh * win + firsts[kh] % vec for kh in range(3)]
            ok = (idx >= -w) & (idx < hw + w)
            rows = np.zeros((cp, 3 * win), np.float32)
            rows[:, ok] = ext[n][:, idx[ok] + w]
            xt = rows.reshape(cp // 8, 8, 3 * win).transpose(0, 2, 1)  # [c/8][row][8]
            for ks in range(-(-min(step, hw - p0) // 16)):
                for kh in range(3):
                    for kw in range(3):
                        r = row0[kh] + kw + 16 * ks + np.arange(16)
                        b = xt[:, r, :].transpose(1, 0, 2).reshape(16, cp)
                        a = masked[kw][:, 16 * ks:16 * ks + 16]
                        acc[kh * 3 + kw] += np.matmul(a, b, dtype=np.float32)
        dw += acc
    return dw[:, :, :c_in].reshape(3, 3, f_out, c_in).transpose(2, 3, 0, 1)


def _split_tf32_np(a):
    """The kernels' split of f32 values into TF32 parts (``split_tf32`` in
    conv3x3_common.cuh): big rounded to nearest with ties away from zero by
    an integer add and mask, small = a - big (exact) truncated to TF32."""
    a = np.ascontiguousarray(a, np.float32)
    big = ((a.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small = ((a - big).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return big, small


def _tf32_filter_grad_model(x, dy, top=None, bottom=None, chunk=2):
    """dw as the f32 instance (3xTF32 on TF32 ``wgmma``) computes it, in
    numpy: dw^T tiles (channels x f) over pipeline steps of 64 pixels of one
    image; for each kh a window of x of 76 plane pixels from p0 + (kh - 1) W
    - 1 rounded down to 4 (zeros outside the plane, or the halo rows); the
    A operand of tap (kh, kw) and pixel p is window element p + kw + the
    start's rounding, zero where the tap wraps across the image's left
    (kw = 0) or right (kw = 2) edge, split into big and small TF32 parts;
    dy (zero past the plane) split likewise; per slice of 8 pixels (slices
    past the plane skipped) the three products a_small b_big + a_big b_small
    + a_big b_big, summed over the step in the tensor cores (exactly here,
    then rounded to f32) and added to the running sums with an f32 add;
    blocks of ``chunk`` steps, then the splits added in order in f32."""
    n_img, c_in, h, w = x.shape
    f_out = dy.shape[1]
    hw, step, box = h * w, 64, 76
    per_image = -(-hw // step)
    total = n_img * per_image

    def halo(t):
        return np.zeros((n_img, c_in, w), np.float32) if t is None else t[:, :, 0]

    # each plane with its row -1 before it and row H after it, zeros beyond
    ext = np.concatenate([halo(top), x.reshape(n_img, c_in, hw), halo(bottom)], axis=2)
    dw = np.zeros((9, f_out, c_in), np.float32)
    for t0 in range(0, total, chunk):
        acc = np.zeros((9, f_out, c_in), np.float32)
        for t in range(t0, min(t0 + chunk, total)):
            n, p0 = t // per_image, t % per_image * step
            pix = p0 + np.arange(step)
            d = np.zeros((f_out, step), np.float32)
            d[:, pix < hw] = dy[n].reshape(f_out, hw)[:, pix[pix < hw]]
            npx = 8 * -(-min(step, hw - p0) // 8)
            d_big, d_small = _split_tf32_np(d[:, :npx])
            col = pix[:npx] % w
            for kh in range(3):
                start = p0 + (kh - 1) * w - 1
                first = start & ~3
                idx = first + np.arange(box)
                ok = (idx >= -w) & (idx < hw + w)
                win = np.zeros((c_in, box), np.float32)
                win[:, ok] = ext[n][:, idx[ok] + w]
                for kw in range(3):
                    a = win[:, start - first + kw + np.arange(npx)]
                    if kw != 1:
                        a = np.where((col == 0) if kw == 0 else (col == w - 1), np.float32(0), a)
                    a_big, a_small = _split_tf32_np(a)
                    prod = (a_small.astype(np.float64) @ d_big.T + a_big.astype(np.float64)
                            @ d_small.T + a_big.astype(np.float64) @ d_big.T)
                    acc[kh * 3 + kw] += prod.astype(np.float32).T
        dw += acc
    return dw.reshape(3, 3, f_out, c_in).transpose(2, 3, 0, 1)


def _bf16_values(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", [(3, 7, 7, 5, 10), (2, 13, 9, 16, 24), tc.ALIGN_CASES[0],
                                  (3, 5, 14, 12, 16, "halo")])
def test_wgmma_filter_grad_decomposition(case, dtype):
    """Each instance's decomposition against the Pallas prototype in
    interpret mode and the plain version in f64, within ``DW_OF_MAX`` of
    max |dw|: bf16 (``_wgmma_filter_grad_model``: dy masked per kw, x
    transposed to [c / 8][pixel][8] and read at whole-row offsets, f32
    slices and ordered splits), f32 (``_tf32_filter_grad_model``: x masked
    per kw at any shift, 3xTF32 splits of both operands, a step's products
    summed before each f32 add, ordered splits).  Ragged cases have C not a
    multiple of 8; the halo case gives x's rows -1 and H (the prototype
    sees them as rows of a taller image whose dy is zero there)."""
    b, h, w, c, f = case[:5]
    rng = np.random.default_rng(sum(case[:5]))
    if dtype == "bf16":
        def values(shape):
            return _bf16_values(rng, shape)
    else:
        def values(shape):
            return rng.normal(size=shape).astype(np.float32)
    x, dy = values((b, c, h, w)), values((b, f, h, w))
    top = bottom = None
    if len(case) > 5:
        top, bottom = values((b, c, 1, w)), values((b, c, 1, w))
    model = _wgmma_filter_grad_model if dtype == "bf16" else _tf32_filter_grad_model
    got = model(x, dy, top, bottom)

    def t64(a):
        return None if a is None else torch.from_numpy(a).double()

    ref = tc._plain_filter_grad(t64(x), t64(dy), t64(top), t64(bottom)).numpy()
    xj, dyj = x.transpose(0, 2, 3, 1), dy.transpose(0, 2, 3, 1)
    if top is not None:  # the taller image: the halo rows on, dy zero on them
        xj = np.concatenate([top.transpose(0, 2, 3, 1), xj, bottom.transpose(0, 2, 3, 1)], 1)
        dyj = np.pad(dyj, ((0, 0), (1, 1), (0, 0), (0, 0)))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    proto = np.asarray(j_filter_grad(jnp.asarray(xj, jdt), jnp.asarray(dyj, jdt),
                                     batch_tile=1, interpret=True)).transpose(3, 2, 0, 1)
    bound = tc.DW_OF_MAX * np.abs(ref).max()
    assert got.shape == ref.shape == proto.shape == (f, c, 3, 3)
    assert np.abs(got - ref).max() <= bound
    assert np.abs(got - proto).max() <= bound


def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _add(a, b):
    """An f32 addition of (value, additions) pairs: the sum, and the most
    additions any term of it has passed through."""
    return (np.float32(a[0] + b[0]), np.maximum(a[1], b[1]) + 1)


def _conv_planes(x, top, bottom, cp):
    """x's planes with C padded to ``cp`` channels, and the halo rows given,
    as {kh: (rows, first pixel)} for the windows that read them (kh = 0 row
    -1 from ``top``, kh = 2 row H from ``bottom``)."""
    n_img, c_in, h, wd = x.shape
    planes = np.zeros((n_img, cp, h * wd), np.float32)
    planes[:, :c_in] = x.reshape(n_img, c_in, h * wd)

    def halo(t):
        out = np.zeros((n_img, cp, wd), np.float32)
        out[:, :c_in] = t[:, :, 0]
        return out

    halos = {0: (halo(top), -wd) if top is not None else None,
             2: (halo(bottom), h * wd) if bottom is not None else None}
    return planes, halos


def _conv_windows(planes, halos, n, p0, wd, vec, box):
    """For each kh the window of ``box`` plane pixels from p0 + (kh - 1) W - 1
    rounded down to ``vec`` as [pixel][c] (zeros outside the plane, the halo
    rows where given), and that start's rounding."""
    hw = planes.shape[2]
    windows = []
    for kh in range(3):
        first = (p0 + (kh - 1) * wd - 1) // vec * vec
        idx = first + np.arange(box)
        win = np.zeros((planes.shape[1], box), np.float32)
        inside = (idx >= 0) & (idx < hw)
        win[:, inside] = planes[n][:, idx[inside]]
        if halos.get(kh) is not None:
            rows, lo = halos[kh]
            on = (idx >= lo) & (idx < lo + wd)
            win[:, on] = rows[n][:, idx[on] - lo]
        windows.append((win.T, p0 + (kh - 1) * wd - 1 - first))
    return windows


def _tap_rows(windows, kh, kw, col, wd, c0, cc):
    """A at tap (kh, kw): each pixel's row of the window at its shift + kw,
    channels c0 .. c0 + cc - 1, zero where the tap wraps across the image's
    left (kw = 0) or right (kw = 2) edge."""
    xt, shift = windows[kh]
    a = xt[np.arange(len(col)) + shift + kw, c0:c0 + cc]
    wrap = (col == 0) if kw == 0 else (col == wd - 1) if kw == 2 else None
    return a if wrap is None else np.where(wrap[:, None], np.float32(0), a)


def _step_sums(v):
    """A step's row of the partial sums of its y (64 pixels x F, zero where
    no pixel), Σy and Σy², in the kernels' tree: a thread's two rows of a
    column (16w + g and 16w + g + 8), the 8 lanes of a column (pairs g ^ 4,
    g ^ 2, g ^ 1), the 4 warps in order; with the additions its terms pass."""
    out = []
    for q in range(2):  # Σy, Σy²
        warps = []
        for wq in range(4):
            lanes = []
            for g in range(8):
                v0, v1 = v[16 * wq + g], v[16 * wq + g + 8]
                if q == 0:
                    lanes.append((np.float32(v0 + v1), 1))
                else:  # fma(v1, v1, v0 * v0): one rounding of the exact sum
                    sq0 = (v0 * v0).astype(np.float32)
                    lanes.append((np.float32(v1.astype(np.float64) ** 2 + sq0), 1))
            for mask in (4, 2, 1):
                lanes = [_add(lanes[g], lanes[g ^ mask]) if not g & mask else None
                         for g in range(8)]
                lanes = [lanes[g & ~mask] for g in range(8)]
            warps.append(lanes[0])
        total = warps[0]
        for wq in range(1, 4):
            total = _add(total, warps[wq])
        out.append(total)
    return out


def _second_pass(part, depth_step):
    """s and ss from the steps' partial rows, 32 phases of rows in order from
    0, then the phases in order; and the most additions any y term passed."""
    stats, depth = [], 0
    rows_total, f_out = part.shape[1:]
    for q in range(2):
        phases = []
        for phase in range(32):
            acc_p = (np.zeros(f_out, np.float32), 0)
            for row in range(phase, rows_total, 32):
                acc_p = _add(acc_p, (part[q, row], depth_step))
            phases.append(acc_p)
        total = (np.zeros(f_out, np.float32), 0)
        for acc_p in phases:
            total = _add(total, acc_p)
        stats.append(total[0])
        depth = max(depth, int(np.max(total[1])))
    return stats[0], stats[1], depth


def _conv_model(x, w, top, bottom, cc, vec, box, chunk_products, to_y):
    """y, s, ss, the additions' depth and the partial rows of a conv +
    statistics instance on ``wgmma``: pipeline steps of 64 pixels of one
    image (pixels as M); chunks of ``cc`` channels; for each kh a window of
    ``box`` plane pixels from p0 + (kh - 1) W - 1 rounded down to ``vec``;
    ``chunk_products(taps, wk)`` sums one chunk's products, given each tap's
    A (64 x cc) and the chunk's weight (F x cc x 9), into the running sums;
    ``to_y`` rounds them to y's dtype; the statistics' tree."""
    n_img, c_in, h, wd = x.shape
    f_out = w.shape[0]
    hw, step = h * wd, 64
    chunks = -(-c_in // cc)
    per_image = -(-hw // step)
    rows_total = n_img * per_image
    wk = np.zeros((f_out, chunks * cc, 9), np.float32)
    wk[:, :c_in] = w.reshape(f_out, c_in, 9)
    planes, halos = _conv_planes(x, top, bottom, chunks * cc)
    y = np.zeros((n_img, f_out, hw), np.float32)
    part = np.zeros((2, rows_total, f_out), np.float32)
    for t in range(rows_total):
        n, p0 = t // per_image, t % per_image * step
        pix = p0 + np.arange(step)
        valid, col = pix < hw, pix % wd
        windows = _conv_windows(planes, halos, n, p0, wd, vec, box)
        acc = np.zeros((step, f_out), np.float32)
        for ch in range(chunks):
            taps = [_tap_rows(windows, kh, kw, col, wd, ch * cc, cc)
                    for kh in range(3) for kw in range(3)]
            acc = chunk_products(acc, taps, wk[:, ch * cc:ch * cc + cc])
        yv = to_y(acc)
        y[n][:, pix[valid]] = yv[valid].T
        sums = _step_sums(np.where(valid[:, None], yv, np.float32(0)))
        part[0, t], depth_step = sums[0]
        part[1, t] = sums[1][0]
    s, ss, depth = _second_pass(part, depth_step)
    return y.reshape(n_img, f_out, h, wd), s, ss, depth, rows_total


def _wgmma_conv_model(x, w, top=None, bottom=None):
    """y, s and ss as the bf16 ``wgmma`` instance of the conv + statistics
    kernel computes them, in numpy, and the most additions any y term passes
    through in the sums (:func:`_conv_model`): chunks of 16 channels, one f32
    product (64 pixels x 16 channels x F) a tap added to the running sums;
    windows of 80 pixels from starts rounded down to 8, transposed to
    [pixel][c], each pixel's row at tap kw its window row + kw, or the zero
    row where the tap wraps; y rounded to bf16."""
    def products(acc, taps, wk):
        for tap, a in enumerate(taps):
            acc = acc + np.matmul(a, wk[:, :, tap].T, dtype=np.float32)
        return acc

    return _conv_model(x, w, top, bottom, 16, 8, 80, products, _bf16_round)


def _tf32_conv_model(x, w, top=None, bottom=None):
    """y, s and ss as the f32 instance (3xTF32 on TF32 ``wgmma``) computes
    them, in numpy, and the additions' depth (:func:`_conv_model`): chunks of
    8 channels; windows of 72 pixels from starts rounded down to 4, read at
    any shift (A in registers), zero where a tap wraps; each tap's A and the
    weight split into big and small TF32 parts, the three products a_small
    w_big + a_big w_small + a_big w_big; a chunk's 72 products of each y
    summed in the tensor cores (exactly here, then rounded to f32) and added
    to the running sums with one f32 add; y stays f32."""
    def products(acc, taps, wk):
        w_big, w_small = _split_tf32_np(wk)
        tmp = np.zeros(acc.shape, np.float64)
        for tap, a in enumerate(taps):
            a_big, a_small = _split_tf32_np(a)
            b_big, b_small = (w_big[:, :, tap].T.astype(np.float64),
                              w_small[:, :, tap].T.astype(np.float64))
            tmp += (a_small.astype(np.float64) @ b_big + a_big.astype(np.float64) @ b_small
                    + a_big.astype(np.float64) @ b_big)
        return acc + tmp.astype(np.float32)

    return _conv_model(x, w, top, bottom, 8, 4, 72, products, lambda acc: acc)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", [(3, 7, 7, 5, 10), (2, 13, 9, 16, 24), tc.ALIGN_CASES[0],
                                  (3, 5, 14, 12, 16, "halo")])
def test_wgmma_conv_bn_stats_decomposition(case, dtype):
    """Each conv + statistics instance's decomposition against the Pallas
    prototype in interpret mode and the plain version: bf16
    (``_wgmma_conv_model``: pixels as M, 16-channel chunks by tap, wrapped
    taps from the zero row, y rounded to bf16) with y within one bf16 ulp;
    f32 (``_tf32_conv_model``: 8-channel chunks, x masked per kw at any
    shift, 3xTF32 splits of both operands, a chunk's products summed before
    each f32 add) with y within ``Y_OF_MAX`` of max |y| of the f64 plain
    version and of the prototype.  Both: Σy and Σy² within the model tree's
    rounding bound (``_sum_depth``, which the model's own count of additions
    must equal) of f64 sums of each reference's y, plus the two y's
    difference.  Ragged cases have C and F past whole tiles; ALIGN_CASES[0]
    has F = 80, one tile of 128; the halo case gives x's rows -1 and H (the
    prototype sees a taller image and its middle rows)."""
    b, h, w, c, f = case[:5]
    rng = np.random.default_rng(sum(case[:5]) + 7)
    if dtype == "bf16":
        def values(shape):
            return _bf16_values(rng, shape)
        k = _bf16_round(rng.normal(0, 0.1, (f, c, 3, 3)))
    else:
        def values(shape):
            return rng.normal(size=shape).astype(np.float32)
        k = rng.normal(0, 0.1, (f, c, 3, 3)).astype(np.float32)
    x = values((b, c, h, w))
    top = bottom = None
    if len(case) > 5:
        top, bottom = values((b, c, 1, w)), values((b, c, 1, w))
    model = _wgmma_conv_model if dtype == "bf16" else _tf32_conv_model
    y, s, ss, depth, rows = model(x, k, top, bottom)
    assert depth == tc._sum_depth(rows)
    u = depth * 2.0**-24

    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float64, jnp.float32))

    def tt(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    y_p, _, _ = tc._plain_conv_bn_stats(tt(x), tt(k), tt(top), tt(bottom))
    xj = x.transpose(0, 2, 3, 1)
    if top is not None:  # the taller image: the halo rows on; y's rows 1 .. H
        xj = np.concatenate([top.transpose(0, 2, 3, 1), xj, bottom.transpose(0, 2, 3, 1)], 1)
    y_j, _, _ = j_conv_bn_stats(jnp.asarray(xj, jdt), jnp.asarray(k.transpose(2, 3, 1, 0), jdt),
                                interpret=True)
    y_j = np.asarray(y_j, np.float32).transpose(0, 3, 1, 2)
    if top is not None:
        y_j = y_j[:, :, 1:h + 1]
    y64 = y.astype(np.float64)
    for ref in (y_p.double().numpy(), y_j.astype(np.float64)):
        assert ref.shape == y.shape == (b, f, h, w)
        if dtype == "bf16":
            np.testing.assert_allclose(y, ref, rtol=2**-7, atol=1e-6)
        else:
            assert np.abs(y64 - ref).max() <= tc.Y_OF_MAX * np.abs(ref).max()
        for got, terms, terms_r in ((s, y64, ref), (ss, y64 * y64, ref * ref)):
            bound = u * np.abs(terms).sum((0, 2, 3)) + np.abs(terms - terms_r).sum((0, 2, 3))
            assert (np.abs(got - terms_r.sum((0, 2, 3))) <= bound).all()
            # and the tree's own rounding against f64 sums of the model's y
            assert (np.abs(got - terms.sum((0, 2, 3)))
                    <= u * np.abs(terms).sum((0, 2, 3))).all()


def _tf32(t):
    """f32 -> TF32 (10 mantissa bits), round to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits to
    the magnitude, then clear them."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(t):
    """f32 -> TF32 by clearing the 13 low mantissa bits."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _filter_grad_in_tf32(x, dy, products):
    """dw from TF32 operands, summed in f64, as the f32 kernel (TF32
    ``wgmma``) pairs them: x is the A operand, split in registers into x_big
    = tf32(x) rounded and x_small = x - x_big truncated to TF32; dy is B,
    split likewise in shared memory; ``products`` 3 is its 3xTF32, the
    three ``wgmma`` of a slice in their order, x_small * dy_big + x_big *
    dy_small + x_big * dy_big; 1 is a single TF32 product, x_big * dy_big.
    The kernel's f32 accumulation (a step's products summed in the tensor
    cores, then f32 adds) is held on the card and in
    ``_tf32_filter_grad_model``."""
    xb, db = _tf32(x), _tf32(dy)
    pairs = [(_tf32_truncated(x - xb), db), (xb, _tf32_truncated(dy - db)), (xb, db)]
    return sum(tc._plain_filter_grad(a.double(), b.double()) for a, b in pairs[-products:])


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("case", [(4, 8, 8, 8, 16), (2, 13, 9, 5, 10), (3, 7, 7, 40, 72)])
def test_3xtf32_filter_grad_within_dw_of_max(case, products):
    """The f32 filter-gradient kernel's split (x in registers, dy in shared
    memory): 3xTF32 keeps dw within ``DW_OF_MAX`` of max |dw| of the f64
    reference; one TF32 product (2**-11 relative) misses that bound."""
    b, h, w, c, f = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(b, f, h, w)).astype(np.float32))
    ref = tc._plain_filter_grad(x.double(), dy.double())
    err = (_filter_grad_in_tf32(x, dy, products) - ref).abs().max().item()
    of_max = err / ref.abs().max().item()
    if products == 3:
        assert of_max <= tc.DW_OF_MAX
    else:
        assert of_max > tc.DW_OF_MAX


def _conv_in_tf32(x, w, products):
    """y from TF32 operands, summed in f64: ``products`` 3 is the f32 conv
    kernel's 3xTF32 (x_big * w_big + x_big * w_small + x_small * w_big, the
    split as in :func:`_filter_grad_in_tf32`); 1 is a single TF32 product.
    The kernel's f32 sums are held on the card."""
    xb, wb = _tf32(x), _tf32(w)
    pairs = [(xb, wb), (xb, _tf32_truncated(w - wb)),
             (_tf32_truncated(x - xb), wb)][:products]
    return sum(tc._plain_conv_bn_stats(a.double(), b.double())[0] for a, b in pairs)


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("case", [(2, 8, 8, 16, 8), (3, 7, 7, 5, 10)])
def test_3xtf32_conv_within_y_of_max(case, products):
    """The f32 conv + statistics kernel's split: 3xTF32 keeps y within
    ``Y_OF_MAX`` of max |y| of the f64 conv; one TF32 product (2**-11
    relative) misses that bound."""
    b, h, w, c, f = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    wt = torch.from_numpy(
        (rng.normal(size=(f, c, 3, 3)) * np.sqrt(2 / (9 * c))).astype(np.float32))
    ref = tc._plain_conv_bn_stats(x.double(), wt.double())[0]
    err = (_conv_in_tf32(x, wt, products) - ref).abs().max().item()
    of_max = err / ref.abs().max().item()
    if products == 3:
        assert of_max <= tc.Y_OF_MAX
    else:
        assert of_max > tc.Y_OF_MAX


def _bn_params(f, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, f).astype(np.float32),
            (rng.normal(size=f) * 0.1).astype(np.float32))


def _torch_bn(scale, bias):
    bn = KerasBatchNorm(len(scale))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn


@pytest.fixture(scope="module")
def conv_bn_case():
    """x (3, 6, 5, 8) NHWC, w (3, 3, 8, 12), BN scale/bias, a random
    cotangent R; the JAX loss sum(BN(conv(x, w)) * R), its gradients to x,
    w, scale and bias, and the new running statistics."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 6, 5, 8)) + 0.3).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, 8, 12)).astype(np.float32)
    scale, bias = _bn_params(12)
    r = rng.normal(size=(3, 6, 5, 12)).astype(np.float32)
    jbn = JKerasBatchNorm()
    stats = jbn.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, 12)))["batch_stats"]

    def loss(x, k, scale, bias):
        y = jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        out, new = jbn.apply(
            {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
             "batch_stats": stats}, y, train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), new["batch_stats"]["BatchNorm_0"]

    (value, new), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias))
    return dict(x=x, k=k, scale=scale, bias=bias, r=r, value=float(value),
                grads=[np.asarray(g) for g in grads],
                mean=np.asarray(new["mean"]), var=np.asarray(new["var"]))


def _torch_loss(case, fused):
    """(loss, [x, w, scale, bias] leaves, bn) through the fused op, or
    through a plain conv + the F.batch_norm form of KerasBatchNorm."""
    x = _nchw(case["x"]).requires_grad_()
    w = _oihw(case["k"]).requires_grad_()
    bn = _torch_bn(case["scale"], case["bias"])
    out = (bn.forward_from_stats(*tc.conv3x3_bn_stats(x, w)) if fused
           else bn(F.conv2d(x, w, padding=1)))
    loss = (out * _nchw(case["r"])).sum()
    loss.backward()
    return loss, [x, w, bn.weight, bn.bias], bn


# f32 sums over 90 elements per channel and up to 108 products per output:
# values and gradients agree to a few ulp of their size.
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def test_conv_bn_stats_gradients_match_plain_autograd_and_jax(conv_bn_case):
    """Catches a missing g_s / g_ss term: BN's batch mean and variance feed
    the loss, so their cotangents reach x and w only through them."""
    loss, leaves, bn = _torch_loss(conv_bn_case, fused=True)
    loss_p, leaves_p, bn_p = _torch_loss(conv_bn_case, fused=False)
    np.testing.assert_allclose(loss.item(), conv_bn_case["value"], rtol=1e-5)
    np.testing.assert_allclose(loss_p.item(), loss.item(), rtol=1e-5)
    for name, a, b in zip(("x", "w", "scale", "bias"), leaves, leaves_p):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL, msg=name)
    x_g, k_g, scale_g, bias_g = conv_bn_case["grads"]
    np.testing.assert_allclose(_nhwc(leaves[0].grad), x_g, **GRAD_TOL)
    np.testing.assert_allclose(leaves[1].grad.permute(2, 3, 1, 0).numpy(), k_g,
                               **GRAD_TOL)
    np.testing.assert_allclose(leaves[2].grad.numpy(), scale_g, **GRAD_TOL)
    np.testing.assert_allclose(leaves[3].grad.numpy(), bias_g, **GRAD_TOL)
    for got in (bn, bn_p):
        np.testing.assert_allclose(got.running_mean.numpy(), conv_bn_case["mean"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.running_var.numpy(), conv_bn_case["var"],
                                   rtol=1e-5, atol=1e-6)


def test_eval_mode_uses_running_statistics(conv_bn_case):
    x = _nchw(conv_bn_case["x"])
    w = _oihw(conv_bn_case["k"])
    bn = _torch_bn(conv_bn_case["scale"], conv_bn_case["bias"])
    with torch.no_grad():
        bn.running_mean.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(0))
        bn.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(1))
    bn.eval()
    before = (bn.running_mean.clone(), bn.running_var.clone())
    with torch.no_grad():
        got = bn.forward_from_stats(*tc.conv3x3_bn_stats(x, w))
        ref = bn(F.conv2d(x, w, padding=1))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close((bn.running_mean, bn.running_var), before)


def test_plain_op_equals_the_cpu_path(conv_bn_case):
    """On the CPU the kernel op runs the plain versions: the reference op
    gives the same bits."""
    x = _nchw(conv_bn_case["x"]).requires_grad_()
    w = _oihw(conv_bn_case["k"]).requires_grad_()
    outs = tc.conv3x3_bn_stats(x, w)
    outs_p = tc.plain_conv3x3_bn_stats(x, w)
    for a, b in zip(outs, outs_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.autograd.grad(sum(o.sum() for o in outs), (x, w))
    g_p = torch.autograd.grad(sum(o.sum() for o in outs_p), (x, w))
    torch.testing.assert_close(g, g_p, rtol=0, atol=0)


def test_autocast_casts_to_bf16_and_keeps_stats_f32():
    """Under autocast the op sees bf16 x and w; y is bf16, the statistics
    and the weight's gradient f32 (the parameter's dtype)."""
    x, k = _conv_inputs(2, 6, 6, 8, 16)
    xt = _nchw(x).requires_grad_()
    wt = _oihw(k).requires_grad_()
    bn = _torch_bn(*_bn_params(16))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y, s, ss = tc.conv3x3_bn_stats(xt, wt)
        out = bn.forward_from_stats(y, s, ss)
    assert y.dtype == out.dtype == torch.bfloat16
    assert s.dtype == ss.dtype == torch.float32
    y_r, s_r, ss_r = tc._plain_conv_bn_stats(xt.detach().bfloat16(),
                                             wt.detach().bfloat16())
    torch.testing.assert_close((y, s, ss), (y_r, s_r, ss_r), rtol=0, atol=0)
    out.float().sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.float32
    assert torch.isfinite(wt.grad).all() and wt.grad.abs().sum() > 0


def test_total_cotangent_terms():
    """g_y + g_s + 2 y g_ss, each term present or absent."""
    y = torch.randn(2, 3, 4, 5)
    g_y, g_s, g_ss = torch.randn(2, 3, 4, 5), torch.randn(3), torch.randn(3)
    full = tc._total_cotangent(y, g_y, g_s, g_ss)
    torch.testing.assert_close(
        full, g_y + g_s.view(1, 3, 1, 1) + 2 * y * g_ss.view(1, 3, 1, 1))
    torch.testing.assert_close(tc._total_cotangent(y, None, g_s, None),
                               g_s.view(1, 3, 1, 1).expand(2, 3, 4, 5))


def test_cpu_tensors_launch_no_kernel(conv_bn_case):
    before = (tc.launches_conv_bn_stats, tc.launches_filter_grad)
    _torch_loss(conv_bn_case, fused=True)
    assert (tc.launches_conv_bn_stats, tc.launches_filter_grad) == before == (0, 0)


def test_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tc._launch_conv_bn_stats(x, torch.zeros(4, 2, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tc._launch_filter_grad(x, torch.zeros(1, 4, 3, 3))


@pytest.mark.parametrize("case", [c for c in tc.CHECK_CASES
                                  if c not in tc.STAGE_SHAPES + tc.STAGE_SHAPES_448])
def test_check_inputs_are_he_scaled(case):
    """The kernels' check inputs (ragged cases here; the stage shapes are
    the same draw at batch 128 and 24): shapes and the weights' He scale."""
    b, h, w, c, f = case
    x, wt, dy = tc.check_inputs(case, torch.float32, torch.Generator().manual_seed(0))
    assert (x.shape, wt.shape, dy.shape) == ((b, c, h, w), (f, c, 3, 3), (b, f, h, w))
    np.testing.assert_allclose(wt.std().item(), np.sqrt(2 / (9 * c)), rtol=0.2)
