"""Data parallelism: process groups, batch slices, collectives and device
lists (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package runs ``--gpus N`` as one process over an N-device mesh, and
that run is numerically the single-device run on the global batch.  Here
training runs one process per card, joined by ``torch.distributed`` (NCCL on
CUDA, gloo on the CPU): each rank takes its contiguous rows of every global
batch (:func:`process_slice`), the gradients are summed over the group in
one flat buffer and divided by the world size once (:func:`reduce_gradients`),
and BatchNorm's per-channel sums cross the group through
:func:`all_reduce_sum` (``models/layers.py``).  Retrieval and serving run one
process over a list of devices (:func:`get_devices`), as the JAX package's
single-host mesh does.

Under ``--spatial S`` the ranks form a ``(N / S, S)`` grid
(:mod:`.spatial`): the batch splits over the D = N / S data shards
(:func:`data_size`, :func:`data_rank`), the columns of a shard split its
images' rows, and the gradients are divided by D.

Outside a group (one process, or no launcher) every helper here is the
identity, so the single-device path is what it was.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from . import spatial


def launched():
    """Whether this process runs under a launcher's environment."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE"))


def in_group():
    return dist.is_available() and dist.is_initialized()


def world_size():
    """Ranks in the process group (1 outside one)."""
    return dist.get_world_size() if in_group() else 1


def rank():
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if in_group() else 0


def data_size():
    """Data shards of the run: the world over the spatial columns (the JAX
    mesh's ``data`` axis)."""
    grid = spatial.current_grid()
    return world_size() if grid is None else grid.data


def data_rank():
    """This rank's data shard (its row of the grid)."""
    grid = spatial.current_grid()
    return rank() if grid is None else grid.data_index


def is_main():
    """Whether this process writes the run's output (rank 0)."""
    return rank() == 0


def local_rank():
    """The launcher's ``LOCAL_RANK`` (else ``RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def initialize_distributed(device="cpu", backend=None):
    """Joins the process group the launcher's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them), over ``backend``: by default NCCL for a CUDA
    ``device``, gloo for the CPU.  A group the caller already started is
    kept as it is; a process that runs alone joins none.  Returns whether a
    group is up."""
    if in_group():
        return True
    if not launched():
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def finalize_distributed():
    """Leaves the process group, if any."""
    if in_group():
        dist.destroy_process_group()


def rank_device(device):
    """The device of this rank: a bare ``cuda`` becomes ``cuda:LOCAL_RANK``
    under a launcher; any other device stays as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not launched():
        return device
    index = local_rank()
    if index >= torch.cuda.device_count():
        raise SystemExit(f"rank {index} has no card: {torch.cuda.device_count()} visible")
    return torch.device("cuda", index)


def process_slice(n: int, process_index=None, process_count=None):
    """The contiguous [start, stop) rows of a global batch of ``n`` that this
    process must provide: equal contiguous slices, in order of data shard
    (each rank's own under data parallelism; the spatial columns of one
    shard take the same rows).

    Pure arithmetic; ``n`` must divide evenly across processes."""
    idx = data_rank() if process_index is None else process_index
    cnt = data_size() if process_count is None else process_count
    if n % cnt:
        raise ValueError(f"global batch {n} not divisible by {cnt} hosts")
    per = n // cnt
    return idx * per, (idx + 1) * per


def shard_batch(batch, process_index=None, process_count=None):
    """This rank's rows of a global batch: every array leaf of the dict
    ``batch`` whose leading dimension is the global batch is sliced to
    :func:`process_slice`, and ``rows`` = (start, stop, n) records where
    they lie, so that the augmentation is drawn for all n rows and applied
    to these.  The batch as it is when the run has one data shard."""
    cnt = data_size() if process_count is None else process_count
    if cnt == 1 or "rows" in batch:
        return batch
    lengths = {len(v) for v in batch.values() if getattr(v, "ndim", 0) > 0}
    if len(lengths) != 1:
        raise ValueError(f"batch leaves disagree on the batch size: {sorted(lengths)}")
    n = lengths.pop()
    start, stop = process_slice(n, process_index, cnt)
    out = {k: v[start:stop] if getattr(v, "ndim", 0) > 0 else v for k, v in batch.items()}
    out["rows"] = (start, stop, n)
    return out


def local_rows(raw, b):
    """``(start, stop, n)``: where a batch of ``b`` local rows lies in its
    global batch (all of it outside a group)."""
    return raw.get("rows", (0, b, b))


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; its backward sums the cotangents over the group,
    so each rank's inputs take the gradient of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group=None):
    """``x`` summed over ``group`` (the whole process group by default),
    differentiable (the identity outside a group of more than one rank)."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def sum_over_group(x, group=None):
    """A new tensor: ``x`` summed over ``group`` (the whole process group by
    default; no autograd)."""
    x = x.detach().clone()
    if world_size() > 1:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def reduce_gradients(grads):
    """The gradients summed over every rank and divided by the data shards
    (:func:`data_size`: the world size under data parallelism), in place:
    one flat buffer a dtype, one ``all_reduce`` each.  Under a spatial grid
    each rank's loss is already 1 / S of its shard's (see
    :mod:`.spatial`), so this is the global batch's mean gradient too.  The
    gradients as they are outside a group."""
    if not in_group():
        return grads
    world = data_size()
    by_dtype = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for index in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in index])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for i in index:
            n = grads[i].numel()
            grads[i].copy_(flat[offset:offset + n].view_as(grads[i]))
            offset += n
    return grads


@torch.no_grad()
def broadcast_state(module, extra=(), src=0):
    """Rank ``src``'s parameters and buffers of ``module``, and the tensors
    ``extra`` (an optimizer's slots), on every rank."""
    if world_size() == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()) + list(extra):
        dist.broadcast(t.data, src)
    return module


def gather_rows(local, n_global, start):
    """The (n_global, ...) tensor whose rows [start, start + len(local)) are
    this rank's ``local`` rows: every rank's rows put in a zero buffer and
    summed over the group, which is exact (x + 0 = x), and needs only the
    ``all_reduce`` that gloo gives CUDA tensors.  Under a spatial grid the
    columns of a data shard hold the same rows, and column 0 gives them."""
    if world_size() == 1:
        return local
    full = local.new_zeros((n_global,) + tuple(local.shape[1:]))
    grid = spatial.current_grid()
    if grid is None or grid.column == 0:
        full[start:start + local.shape[0]] = local
    dist.all_reduce(full)
    return full


def get_devices(n_devices=None, device="cuda"):
    """A list of ``n_devices`` devices for one process (the counterpart of
    the JAX package's single-host mesh): CUDA cards from ``device``'s index
    on, or the CPU, which stands in for any number of devices (as the JAX
    tests' host devices do).  Raises when fewer cards are present."""
    device = torch.device(device)
    n = 1 if n_devices is None else int(n_devices)
    if device.type != "cuda":
        return [device] * n
    first = device.index or 0
    present = torch.cuda.device_count() - first
    if n > present:
        raise ValueError(f"Requested {n} devices but only {present} present.")
    return [torch.device("cuda", first + i) for i in range(n)]


def free_port():
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(index, fn, world, port, args):
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    # the ranks share the host's cores (on the CPU they are the devices)
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    fn(*args)


def launch(fn, nprocs, *args):
    """Runs ``fn(*args)`` in ``nprocs`` spawned processes, each under a
    launcher's environment (rank i of ``nprocs``, a free port on localhost),
    and waits for all of them; raises if any fails.  ``fn`` must be
    importable (a module's top-level function)."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(fn, nprocs, free_port(), args), nprocs=nprocs,
                       join=True, start_method="spawn")
