"""Spatial partitioning: each image's rows split over the columns of a
(data, spatial) grid of ranks (counterpart of the JAX package's
``get_mesh(spatial=)``, ``spatial_size``, ``image_sharding`` and
``constrain_spatial``).

``--gpus N --spatial S`` runs N ranks as a ``(N / S, S)`` grid in row-major
order, as the JAX package folds its devices (``np.reshape(devices,
(N // S, S))``): rank ``d * S + s`` is data shard ``d``, spatial column
``s``.  The ranks of one data shard (its *spatial group*) hold the same
images, each a block of their rows; the ranks of one column form a *data
group*.  The JAX package leaves the halo exchanges to GSPMD; here the
model's primitives (``models/layers.py``) make them themselves, under the
grid this module holds for the process (:func:`set_grid`):

- Every map's rows split over the S columns in contiguous blocks of
  ``ceil(H / S)`` (:func:`block`); the last blocks may be shorter or empty,
  as GSPMD pads.  :func:`constrain_spatial` cuts a data shard's whole
  images (prepared, augmentation included, on every rank of the shard) to
  this column's rows, as the JAX steps constrain them right after
  ``prepare``, and notes the image's global height.
- A layer whose output rows read other rows (a conv or pool taller than a
  row, a stride, a pad, a shift, an upsampling) fetches the input rows its
  output block needs from the ranks that hold them (:func:`rows`,
  :func:`halo`), zero-filled outside the image (-inf for max pooling), TF
  SAME's top/bottom split read from the global height.  The fetch is an
  ``autograd.Function`` whose backward sends each fetched row's cotangent
  back to its owner, which adds it.  The global height of a map is looked
  up by its width, which no rank splits (:func:`global_height`).
- Reductions over the whole map (global pools, BatchNorm's sums, the
  gather a flatten needs) cross the spatial group through a summing
  ``all_reduce`` whose backward sums the cotangents
  (:func:`..mesh.all_reduce_sum`).

The gradient rule (``train/trainer.py::finish_step``): after the global pool
every column of a data shard computes the head and the loss of the same
images, so each rank's loss is scaled by 1 / S; the pool's summing backward
then gives every column the whole cotangent of the pooled features, each
row's partial gradients belong to the rank that holds the row, and the
parameters' gradients, summed over all N ranks, are divided by D = N / S
(:func:`..mesh.reduce_gradients`).  That is the exact gradient of the mean
loss over the global batch: every collective's backward is its transpose.

Transport: one ``all_reduce`` over the spatial group of a buffer that is
zero but for the rows each rank owns (exact: x + 0 = x), the only
collective gloo gives CUDA tensors; over gloo bf16 rows travel as f32.  A
layer whose blocks need no row of another rank makes no collective.  Every
rank of a group runs the same layers in the same order, so the collectives
of the forward and of the backward pair up.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import mesh

#: the grid of this process (None: every rank its own data shard)
_GRID = None
#: global height of each map by its width, since the last constrain_spatial
_HEIGHTS = {}


class Grid:
    """The ``(data, spatial)`` grid of ``world`` ranks seen from ``rank``.

    ``groups=True`` (in a process group) makes the spatial groups and the
    data groups with ``dist.new_group``: every rank makes every group, in
    one order, as ``new_group`` requires."""

    def __init__(self, spatial, world, rank, groups=True):
        spatial = max(1, int(spatial))
        if world % spatial:
            raise ValueError(
                f"{world} devices do not fold into spatial={spatial} columns; device "
                "count must be a multiple of spatial.")
        self.spatial, self.data, self.world, self.rank = spatial, world // spatial, world, rank
        self.data_index, self.column = divmod(rank, spatial)
        self.spatial_group = self.data_group = None
        if groups and mesh.in_group() and world > 1:
            for d in range(self.data):
                group = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                if d == self.data_index:
                    self.spatial_group = group
            for s in range(spatial):
                group = dist.new_group(list(range(s, world, spatial)))
                if s == self.column:
                    self.data_group = group

    @property
    def shape(self):
        """``(data, spatial)``: the JAX mesh's ``dict(mesh.shape)`` values."""
        return self.data, self.spatial


def get_grid(spatial=1, world=None, rank=None, groups=True):
    """The grid of the process group's ranks (``world`` and ``rank`` from
    the group unless given), ``spatial`` columns wide."""
    world = mesh.world_size() if world is None else world
    rank = mesh.rank() if rank is None else rank
    return Grid(spatial, world, rank, groups=groups)


def set_grid(grid):
    """Makes ``grid`` this process's grid (None: none); returns the one it
    replaces."""
    global _GRID
    before, _GRID = _GRID, grid
    _HEIGHTS.clear()
    return before


def current_grid():
    return _GRID


def spatial_size(grid=None):
    """Spatial columns of ``grid`` (this process's by default); 1 without a
    grid."""
    grid = _GRID if grid is None else grid
    return 1 if grid is None else grid.spatial


def active():
    """Whether the model's maps are row blocks here: a grid of more than one
    spatial column."""
    return _GRID is not None and _GRID.spatial > 1


def block(h, column=None, spatial=None):
    """``(a, b)``: the rows of a map of ``h`` rows that ``column`` (this
    rank's by default) holds: blocks of ``ceil(h / spatial)``, the last ones
    shorter or empty."""
    spatial = _GRID.spatial if spatial is None else spatial
    column = _GRID.column if column is None else column
    per = -(-h // spatial)
    a = min(column * per, h)
    return a, min(a + per, h)


def image_sharding(grid, n, h):
    """Where this rank's part of a global NHWC batch of ``n`` images of ``h``
    rows lies: ``((start, stop), (a, b))``, its images (its data shard's)
    and its rows of each (the JAX package's ``PartitionSpec(data,
    spatial)``)."""
    start, stop = mesh.process_slice(n, grid.data_index, grid.data)
    return (start, stop), block(h, grid.column, grid.spatial)


def constrain_spatial(images):
    """This column's rows of a data shard's NHWC ``images`` under a spatial
    grid, noting their global height; the images as they are otherwise."""
    if not active():
        return images
    _HEIGHTS.clear()
    _HEIGHTS[images.shape[2]] = images.shape[1]
    a, b = block(images.shape[1])
    return images[:, a:b]


def global_height(x):
    """The global height of the NCHW map whose row block ``x`` is."""
    h = _HEIGHTS.get(x.shape[3])
    if h is None:
        raise RuntimeError(
            f"no global height is known for a map {x.shape[3]} wide: only maps "
            "that come from constrain_spatial's images through the model's "
            "primitives are row blocks")
    a, b = block(h)
    if x.shape[2] != b - a:
        raise RuntimeError(
            f"a map of {x.shape[3]} columns and {h} rows gives column "
            f"{_GRID.column} {b - a} rows, not {x.shape[2]}: maps of one width "
            "with two heights cannot be told apart")
    return h


def record(y, h):
    """Notes that the row block ``y`` is of a map of ``h`` global rows;
    returns ``y``."""
    known = _HEIGHTS.setdefault(y.shape[3], h)
    if known != h:
        raise RuntimeError(f"maps {y.shape[3]} wide of {known} and of {h} rows: "
                           "spatial partitioning tells maps apart by width")
    return y


# ---------------------------------------------------------------------------
# Fetching rows
# ---------------------------------------------------------------------------


def _per_column(h_out, reads):
    """For each column: ``reads(a, b)`` for its output block ``[a, b)`` of a
    map of ``h_out`` rows, or ``(0, 0)`` (none) for an empty block."""
    out = []
    for s in range(_GRID.spatial):
        a, b = block(h_out, s, _GRID.spatial)
        out.append(reads(a, b) if a < b else (0, 0))
    return out


def conv_needs(h_out, k=1, stride=1, pad=0):
    """The input rows ``[lo, hi)`` each column's output block reads where
    output row o reads input rows ``o * stride - pad + [0, k)`` (a conv or
    pool, VALID in H once ``pad`` rows are on top; a pad or a shift with
    ``k = 1``)."""
    return _per_column(h_out, lambda a, b: (a * stride - pad, (b - 1) * stride - pad + k))


def upsample_needs(h_out, factor):
    """The input rows each column's output block reads where output row o
    reads input row ``o // factor`` (nearest or sub-pixel upsampling)."""
    return _per_column(h_out, lambda a, b: (a // factor, (b - 1) // factor + 1))


def transpose_needs(h_out, k, stride, pad):
    """The input rows each column's output block reads where input row i
    adds to output rows ``i * stride - pad + [0, k)`` (a transposed conv)."""
    return _per_column(h_out, lambda a, b: (-(-(a + pad - k + 1) // stride),
                                            (b - 1 + pad) // stride + 1))


def _split(need, own):
    """The rows ``need`` splits into around this column's own block ``own``:
    those before it, those of it, those after it (each ``(lo, hi)``)."""
    lo, hi = need
    ia, ib = own
    top = (lo, max(lo, min(hi, ia)))
    bottom = (min(hi, max(lo, ib)), hi)
    return top, (top[1], max(top[1], bottom[0])), bottom


class _Plan:
    """The row exchange of one layer: for every column the rows before and
    after its own block that it reads, and the buffer's layout."""

    def __init__(self, h_in, needs):
        grid = _GRID
        self.spatial, self.column = grid.spatial, grid.column
        self.group = grid.spatial_group
        self.h_in = h_in
        self.own = [block(h_in, s, grid.spatial) for s in range(grid.spatial)]
        self.parts = [_split(n, o) for n, o in zip(needs, self.own)]
        self.tops = max(t[1] - t[0] for t, _, _ in self.parts)
        self.bottoms = max(b[1] - b[0] for _, _, b in self.parts)
        # rows of the image (not fill) that some column reads from another
        self.exchange = any(max(r[0], 0) < min(r[1], h_in)
                            for t, _, b in self.parts for r in (t, b))

    def slots(self, column):
        """(row range, offset in the column's slot) of its top and bottom."""
        top, _, bottom = self.parts[column]
        return (top, 0), (bottom, self.tops)

    def wire_dtype(self, dtype):
        # gloo's all_reduce is sure of f32 and f64; bf16 rows are exact in f32
        if dtype in (torch.float32, torch.float64):
            return dtype
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return dtype
        return torch.float32


def _fill_outside(t, rows, h_in, fill):
    """``t`` (rows ``[rows[0], rows[1])`` of the map) with the rows outside
    the image set to ``fill``."""
    if fill == 0.0 or t.shape[2] == 0:
        return t
    r = torch.arange(rows[0], rows[1], device=t.device)
    outside = ((r < 0) | (r >= h_in)).view(1, 1, -1, 1)
    return t.masked_fill(outside, fill)


class _Halo(torch.autograd.Function):
    """The rows before and after this column's own block that its output
    block reads, from the ranks that hold them (``fill`` outside the
    image); the backward adds each fetched row's cotangent into its
    owner's rows."""

    @staticmethod
    def forward(ctx, x, plan, fill):
        ctx.plan = plan
        n, c, _, w = x.shape
        wire = plan.wire_dtype(x.dtype)
        buf = x.new_zeros((plan.spatial, plan.tops + plan.bottoms, n, c, w), dtype=wire)
        ia, ib = plan.own[plan.column]
        for s in range(plan.spatial):
            for (lo, hi), off in plan.slots(s):
                o0, o1 = max(lo, ia), min(hi, ib)
                if o0 < o1:
                    buf[s, off + o0 - lo:off + o1 - lo] = x[:, :, o0 - ia:o1 - ia].movedim(2, 0)
        dist.all_reduce(buf, group=plan.group)
        out = []
        for (lo, hi), off in plan.slots(plan.column):
            t = buf[plan.column, off:off + hi - lo].movedim(0, 2).to(x.dtype).contiguous()
            out.append(_fill_outside(t, (lo, hi), plan.h_in, fill))
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return tuple(out)

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        plan = ctx.plan
        n, c, h, w = ctx.x_shape
        wire = plan.wire_dtype(ctx.x_dtype)
        buf = g_top.new_zeros((plan.spatial, plan.tops + plan.bottoms, n, c, w), dtype=wire)
        for g, ((lo, hi), off) in zip((g_top, g_bottom), plan.slots(plan.column)):
            if hi > lo:
                buf[plan.column, off:off + hi - lo] = g.movedim(2, 0)
        dist.all_reduce(buf, group=plan.group)
        ia, ib = plan.own[plan.column]
        gx = g_top.new_zeros(ctx.x_shape, dtype=wire)
        for s in range(plan.spatial):
            for (lo, hi), off in plan.slots(s):
                o0, o1 = max(lo, ia), min(hi, ib)
                if o0 < o1:
                    gx[:, :, o0 - ia:o1 - ia] += buf[s, off + o0 - lo:off + o1 - lo].movedim(0, 2)
        return gx.to(ctx.x_dtype), None, None


def halo(x, h_in, needs, fill=0.0):
    """``(top, mid, bottom, lo)`` for the row block ``x`` of a map of
    ``h_in`` rows, where each column reads the input rows ``needs`` gives
    it (:func:`conv_needs` ...): the rows this column reads before its own
    block (fetched, or ``fill`` outside the image), of it (a view of x) and
    after it, and the first of them."""
    plan = _Plan(h_in, needs)
    top, mid, bottom = plan.parts[plan.column]
    ia = plan.own[plan.column][0]
    if plan.exchange:
        t, b = _Halo.apply(x, plan, fill)
    else:  # every row read from outside the own block lies outside the image
        shape = x.shape[:2]
        t, b = (x.new_full(shape + (r[1] - r[0], x.shape[3]), fill) for r in (top, bottom))
    return t, x[:, :, mid[0] - ia:mid[1] - ia], b, top[0]


def rows(x, h_in, needs, fill=0.0):
    """``(x_ext, lo)``: the input rows ``[lo, lo + len)`` that this column
    reads, in one tensor (see :func:`halo`)."""
    t, mid, b, lo = halo(x, h_in, needs, fill)
    # all three, empty or not: the fetch must stay in every rank's graph so
    # that its backward's collective runs on every rank
    return torch.cat([t, mid, b], dim=2), lo


def out_rows(h_out):
    """Rows of this column's block of a map of ``h_out`` rows."""
    a, b = block(h_out)
    return b - a


def valid_rows(fn, x_ext, n_out, k):
    """``fn(x_ext)``, a VALID-in-H window op over the rows ``x_ext``; for an
    empty output block, ``fn`` of ``k`` zero rows with none of its output
    kept, so that every rank runs the same operations (and the backward the
    same collectives)."""
    if n_out:
        return fn(x_ext)
    return fn(F.pad(x_ext, (0, 0, 0, k - x_ext.shape[2])))[:, :, :0]


def rows_of_image(lo, hi, h, device):
    """A (1, 1, hi - lo, 1) f32 mask: 1 for rows ``[lo, hi)`` inside an image
    of ``h`` rows, 0 outside."""
    r = torch.arange(lo, hi, device=device)
    return ((r >= 0) & (r < h)).float().view(1, 1, -1, 1)


# ---------------------------------------------------------------------------
# Reductions over the spatial group
# ---------------------------------------------------------------------------


def pool_sum(x):
    """The f32 (f64 for f64) sum over every row and column of the map whose
    row block is ``x``: (N, C), the same on every column, differentiable."""
    local = x.to(torch.promote_types(x.dtype, torch.float32)).sum(dim=(2, 3))
    return mesh.all_reduce_sum(local, group=_GRID.spatial_group)


def gather_map(x):
    """The whole map whose row block is ``x``, on every column of the
    spatial group, differentiable (its backward takes this column's rows of
    the summed cotangent)."""
    h = global_height(x)
    a, b = block(h)
    return mesh.all_reduce_sum(F.pad(x, (0, 0, a, h - b)), group=_GRID.spatial_group)


class _MaxOverGroup(torch.autograd.Function):
    """Elementwise max of ``x`` over a group; the cotangents, summed over
    the group, go to the ranks that hold the max (split among ties)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        holds = (x == y).to(x.dtype)
        holders = holds.clone()
        dist.all_reduce(holders, group=group)
        ctx.group = group
        ctx.save_for_backward(holds / holders)
        return y

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g * share, None


def pool_max(x):
    """The max over every row and column of the map whose row block is
    ``x``: (N, C), the same on every column, differentiable."""
    local = x.amax(dim=(2, 3)) if x.shape[2] else x.sum(dim=(2, 3)) - math.inf
    return _MaxOverGroup.apply(local.float() if local.dtype == torch.bfloat16 else local,
                               _GRID.spatial_group).to(x.dtype)
