"""Shared CLI plumbing: argument groups, device and precision, model
assembly, feature dumps (the parts of the JAX package's ``cli/common.py``
that the trainer uses)."""

from __future__ import annotations

import contextlib
import json
import os
import pickle

import numpy as np
import torch

from .. import parallel
from ..embeddings import save_features
from ..models import EmbeddingModel, build_network
from ..train import LOSS_OUTPUT, new_train_state
from ..train.trainer import maybe_autocast


def add_lr_schedule_arguments(parser):
    group = parser.add_argument_group("Parameters for --lr_schedule=SGD")
    group.add_argument("--sgd_patience", type=int, default=None,
                       help="Patience of learning rate reduction in epochs.")
    group.add_argument("--sgd_lr", type=float, default=0.1,
                       help="Initial learning rate.")
    group.add_argument("--sgd_min_lr", type=float, default=None,
                       help="Minimum learning rate.")
    group.add_argument("--sgd_schedule", type=str, default=None,
                       help="Comma-separated list of `epoch:lr` pairs, defining "
                            "a learning rate schedule. The total number of "
                            "epochs can be appended to this list, separated by "
                            "a comma as well.")
    group = parser.add_argument_group("Parameters for --lr_schedule=SGDR")
    group.add_argument("--sgdr_base_len", type=int, default=None,
                       help="Length of first cycle in epochs.")
    group.add_argument("--sgdr_mul", type=int, default=None,
                       help="Multiplier for cycle length after each cycle.")
    group.add_argument("--sgdr_max_lr", type=float, default=None,
                       help="Maximum learning rate.")
    group = parser.add_argument_group("Parameters for --lr_schedule=CLR")
    group.add_argument("--clr_step_len", type=int, default=None,
                       help="Length of each step in epochs.")
    group.add_argument("--clr_min_lr", type=float, default=None,
                       help="Minimum learning rate.")
    group.add_argument("--clr_max_lr", type=float, default=None,
                       help="Maximum learning rate.")


def add_common_train_arguments(group):
    group.add_argument("--device", type=str, default="cuda",
                       help="Device to run on (cuda, cuda:N or cpu). A CUDA "
                            "device that is not present is an error.")
    group.add_argument("--gpus", type=int, default=1,
                       help="Number of cards to train on, one process each "
                            "(spawned here, or started by a launcher such as "
                            "torchrun); fewer present: those that are.")
    group.add_argument("--read_workers", type=int, default=8,
                       help="Number of parallel data pre-processing threads "
                            "(file datasets; not used by in-memory ones).")
    group.add_argument("--queue_size", type=int, default=100,
                       help="Maximum size of data queue (file datasets).")
    add_decoder_argument(group)
    group.add_argument("--gpu_merge", action="store_true", default=False,
                       help="Accepted for interface parity.")
    group.add_argument("--bn_per_replica", action="store_true", default=False,
                       help="Compute BatchNorm statistics per data-parallel "
                            "rank (the reference's per-tower BN under "
                            "multi_gpu_model) instead of the default "
                            "global-batch sync BN. See PARITY.md.")
    group.add_argument("--spatial", type=int, default=1,
                       help="Spatial partitioning factor: fold the --gpus "
                            "ranks into a (data, spatial) grid and split each "
                            "image's HEIGHT over the spatial columns (the "
                            "layers exchange halo rows). Scales a single "
                            "large-image batch across cards - for the 448px "
                            "fine-tune recipes whose per-card batch is small. "
                            "Must divide --gpus.")


DECODERS = ("auto", "native", "pillow")


def add_decoder_argument(group):
    group.add_argument("--decoder", choices=DECODERS, default="auto",
                       help="JPEG decoder of the file datasets: the native "
                            "C++ decoder (built with g++ against libjpeg at "
                            "first use; with 'native' a failed build is an "
                            "error), Pillow, or 'auto': the native decoder "
                            "where it builds and loads, else Pillow.")


def resolve_decoder(decoder):
    """``'native'`` or ``'pillow'`` for a ``--decoder`` choice.  ``auto``
    builds and loads the native decoder; where that fails it prints the
    JAX package's message and takes Pillow, as the JAX loader does."""
    if decoder != "auto":
        return decoder
    from .. import native

    try:
        native.loader()
    except RuntimeError as e:
        print(f"native decoder unavailable ({e}); using PIL fallback")
        return "pillow"
    return "native"


def apply_pipeline_args(dataset, args):
    """Wires ``--read_workers`` / ``--queue_size`` / ``--decoder`` onto a
    file dataset (in-memory datasets have none of them).  ``queue_size``
    counts batches, as Keras's ``max_queue_size`` does."""
    if hasattr(dataset, "read_workers"):
        dataset.read_workers = getattr(args, "read_workers", dataset.read_workers)
        dataset.queue_size = getattr(args, "queue_size", dataset.queue_size)
        decoder = getattr(args, "decoder", "auto")
        dataset.use_native = resolve_decoder(decoder) == "native"
        print(f"file pipeline: {dataset.read_workers} read workers, a queue of "
              f"{dataset.queue_size} batches, "
              f"{'native' if dataset.use_native else 'Pillow'} decoder (--decoder {decoder})")
    return dataset


def resolve_device(name):
    """The ``--device``; a CUDA device that is not present raises instead of
    running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device is present (pass --device cpu "
            "to run on the CPU).")
    return device


def set_float32_precision():
    """Sets, in this one place, how float32 convolutions and matmuls run on
    the card, and prints it: full float32, TF32 off for both."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("float32 precision: torch.backends.cudnn.allow_tf32=False, "
          "torch.backends.cuda.matmul.allow_tf32=False (TF32 off)")


def schedule_args_from(args):
    return {name: value for name, value in vars(args).items() if value is not None}


def str2bool(v):
    """The reference's flexible boolean flag parser (used by --norm)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    import argparse

    raise argparse.ArgumentTypeError("Boolean value expected.")


def load_class_embedding(path_or_onehot):
    """Loads an embedding pickle, or None for 'onehot'."""
    if path_or_onehot == "onehot":
        return None, None
    with open(path_or_onehot, "rb") as f:
        dump = pickle.load(f)
    return dump["ind2label"], np.asarray(dump["embedding"], dtype=np.float32)


def check_label_range(dataset, n_rows, what="embedding"):
    """Labels index the embedding/one-hot tables on the device, where an
    out-of-range gather is an error deep inside the first step; validate on
    the host up front."""
    mx = int(max(np.max(dataset.labels_train), np.max(dataset.labels_test)))
    if mx >= n_rows:
        raise SystemExit(
            f"Dataset labels go up to {mx} but the {what} has only "
            f"{n_rows} rows; pass an embedding matching the dataset's "
            "class enumeration (e.g. the right class subset).")


def build_embedding_model(embed_dim, architecture, loss, cls_classes,
                          cls_input="output", input_channels=3, seed=0, remat=False,
                          cls_base=None):
    """Backbone + output transform + optional cls head (on the backbone
    module ``cls_base`` names, if given); the initial weights are drawn on
    the CPU from a ``torch.Generator`` seeded with ``seed``.  ``remat``
    recomputes the residual blocks in the backward pass (``--remat``)."""
    generator = torch.Generator().manual_seed(seed)
    spec = build_network(embed_dim, architecture, input_channels=input_channels,
                         generator=generator, remat=remat)
    model = EmbeddingModel(
        spec.module, output=LOSS_OUTPUT[loss], cls_classes=cls_classes,
        cls_input=cls_input, generator=generator, cls_base=cls_base,
        input_shape=(spec.input_size, spec.input_size, input_channels))
    return model, spec


def init_model_state(model, device):
    return new_train_state(model.to(device))


def print_model_summary(state, architecture):
    params = state.params
    n_params = sum(p.numel() for p in params)
    n_stats = sum(b.numel() for b in state.model.buffers())
    print(
        f"Model: {architecture} — {n_params:,} trainable parameters in "
        f"{len(params)} tensors (+{n_stats:,} batch-norm statistics)")


def extract_test_features(model, dataset, device, batch_size=100, pick=None,
                          autocast_dtype=None):
    """The model's output for every test image, in dataset order (the
    embedding of an (embedding, prob) model unless ``pick`` selects)."""
    return extract_by_tap(model, dataset.make_prepare(device), dataset.test_batches(batch_size),
                          device, pick=pick, autocast_dtype=autocast_dtype)


def dump_artifacts(args, state, model, dataset, device, cls_weight=0.0,
                   meta=None, features=None, autocast_dtype=None):
    """--model_dump / --weight_dump / --feature_dump handling.  Model dumps
    carry the model configuration in their metadata.  In a process group
    every rank takes part in the feature extraction and rank 0 writes."""
    from ..train.state import save_checkpoint, save_weights

    metadata = {"architecture": getattr(args, "architecture", None)}
    if meta:
        metadata.update(meta)
    main = parallel.is_main()

    if getattr(args, "weight_dump", None) and main:
        try:
            save_weights(args.weight_dump, state.model)
        except OSError as e:
            print(f"An error occurred while saving the model weights: {e}")
    if getattr(args, "model_dump", None) and main:
        try:
            save_checkpoint(args.model_dump, state, metadata)
        except OSError as e:
            print(f"An error occurred while saving the model: {e}")
    if getattr(args, "feature_dump", None):
        feats = features if features is not None else extract_test_features(
            model, dataset, device,
            batch_size=getattr(args, "val_batch_size", 100) or 100,
            pick=0 if cls_weight > 0 else None, autocast_dtype=autocast_dtype)
        if main:
            save_features(args.feature_dump, feats)


def read_class_list(path):
    """The first word of each line of ``path``, in order, each once; as ints
    where all of them are."""
    from collections import OrderedDict

    with open(path) as f:
        class_list = list(OrderedDict(
            (line.strip().split()[0], None) for line in f if line.strip()))
    try:
        return [int(c) for c in class_list]
    except ValueError:
        return class_list


def add_finetune_arguments(group, init_epochs):
    group.add_argument("--finetune", type=str, default=None,
                       help="Path to pre-trained weights to be fine-tuned (a "
                            "model, snapshot or weight dump of the port or of the "
                            "JAX package; tensors load by name).")
    group.add_argument("--finetune_init", type=int, default=init_epochs,
                       help="Number of initial epochs for training just the "
                            "new layers before fine-tuning.")


def finetune(args, state, warm_step, eval_step, dataset):
    """``--finetune``: loads the weights by name, then, for
    ``--finetune_init`` epochs, runs the train step ``warm_step()`` builds
    (one that trains the new layers only) at a constant ``--sgd_lr``, with
    no schedule, as the reference's warm-up does; then resets the optimizer
    (zero velocity, step and epoch 0) for the full training, as the
    reference's fresh compile does.  Returns the state."""
    from ..train import fit, load_weights_by_name
    from ..train.optimizer import init_velocity
    from ..train.schedules import PiecewiseSchedule

    print(f"Loading pre-trained weights from {args.finetune}")
    load_weights_by_name(args.finetune, state.model)
    if args.finetune_init > 0:
        print("Pre-training new layers")
        state = fit(state, warm_step(), eval_step, dataset,
                    PiecewiseSchedule([(0, args.sgd_lr)]), epochs=args.finetune_init,
                    batch_size=args.batch_size, val_batch_size=args.val_batch_size,
                    seed=getattr(args, "seed", 0), verbose=not args.no_progress)
        state.velocity = init_velocity(state.params)
        state.step = state.epoch = 0
        print("Full model training")
    return state


def mesh_size(gpus, available=None):
    """The data-parallel degree ``--gpus`` gives when ``available`` devices
    are present (None: any number, as the CPU offers): fewer present, it
    prints the JAX package's message (rank 0 of a launcher's ranks) and
    takes those that are."""
    n = max(1, int(gpus))
    if available is not None and n > available:
        if int(os.environ.get("RANK", 0)) == 0:
            print(f"Requested {n} devices but only {available} present; using {available}.")
        n = available
    return n


def check_spatial(n, spatial):
    """``--spatial`` must divide the ``n`` devices (the JAX package's
    message)."""
    if n % max(1, int(spatial)):
        raise SystemExit(f"--spatial {spatial} must divide the device count ({n}).")


def set_bn_mode(n, bn_per_replica=False, spatial=1):
    """BatchNorm over ``n`` devices folded into ``spatial`` columns: one
    group a data shard under ``--bn_per_replica`` (the spatial columns of a
    shard jointly compute one tower's statistics: they hold slices of the
    same images), else one group (global-batch, sync statistics), with the
    JAX package's NOTE saying so."""
    from ..models.layers import set_default_bn_groups

    shards = n // max(1, int(spatial))
    set_default_bn_groups(shards if bn_per_replica else 1)
    if bn_per_replica:
        if shards > 1:
            print(f"BatchNorm: per-replica statistics over {shards} shards")
    elif shards > 1:
        print(
            f"NOTE: --gpus {n} uses global-batch (sync) BatchNorm statistics; "
            "the reference's multi_gpu_model computes them per tower. Pass "
            "--bn_per_replica to reproduce published multi-GPU recipes "
            "exactly (see PARITY.md / RECIPES.md).")


def resolve_mesh(gpus, bn_per_replica=False, available=None, spatial=1):
    """The JAX package's ``resolve_mesh``: maps ``--gpus`` onto the number
    of devices (:func:`mesh_size`), checks that ``--spatial`` divides it
    and sets BatchNorm's mode for the ``(n / spatial, spatial)`` grid
    (:func:`set_bn_mode`).  Returns the number of devices."""
    n = mesh_size(gpus, available)
    check_spatial(n, spatial)
    set_bn_mode(n, bn_per_replica, spatial)
    return n


def check_mesh_batch(n, *batch_sizes):
    """Batch sizes must divide over the ``n``-way data axis (under a
    spatial grid its data shards only: its columns split the images)."""
    for b in batch_sizes:
        if b and b % n:
            raise SystemExit(
                f"batch size {b} is not divisible by the {n}-way data axis "
                f"of the device mesh; choose a multiple of {n}.")


def sharded():
    """The batch iterators' ``shard`` keyword in a group of several data
    shards (each reads its rows only), else none."""
    return {"shard": True} if parallel.data_size() > 1 else {}


def available_devices(device):
    """How many devices ``--gpus`` may take: a launcher's ``WORLD_SIZE``;
    else the visible cards for a CUDA ``--device``; else None (the CPU
    stands in for any number, each rank a process of its own)."""
    if parallel.launched():
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 1
    return None


def spawn_data_parallel(args, main, argv, spatial=1):
    """``--gpus N`` > 1 with no launcher: runs ``main(argv)`` in N spawned
    processes, one card each (NCCL; gloo on the CPU), and returns True once
    all of them have ended.  Returns False where this process trains
    itself: under a launcher, or on one device.  ``spatial`` (``--spatial``
    where the learner takes it) must divide the devices."""
    if parallel.launched() or parallel.in_group():
        return False
    n = mesh_size(args.gpus, available_devices(args.device))
    check_spatial(n, spatial)
    if n == 1:
        return False
    import sys

    print(f"spawning {n} data-parallel processes", flush=True)
    parallel.launch(main, n, list(sys.argv[1:] if argv is None else argv))
    return True


@contextlib.contextmanager
def data_parallel(args, spatial=1):
    """The training process's side of ``--gpus``: under a launcher it joins
    the group (NCCL for a CUDA ``--device``, gloo on the CPU; a group the
    caller started is kept), folds it into a ``(world / spatial, spatial)``
    grid (``--spatial``, where the learner takes it; :mod:`..parallel.spatial`),
    sets BatchNorm's mode for the grid, and checks the batch sizes divide
    over its data shards; ranks other than 0 print nothing.  Yields
    ``(device, world)``: this rank's device and the group's size.  Leaves a
    group it joined, and the grid, on exit."""
    joins = parallel.launched() and not parallel.in_group()
    if joins:
        world = int(os.environ["WORLD_SIZE"])
        if 1 < args.gpus < world:
            raise SystemExit(f"--gpus {args.gpus} asks for fewer ranks than the "
                             f"launcher's WORLD_SIZE {world}")
        mesh_size(max(args.gpus, world), world)
    device = resolve_device(str(parallel.rank_device(args.device)))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    parallel.initialize_distributed(device)
    world = parallel.world_size()
    try:
        with contextlib.ExitStack() as quiet:
            if not parallel.is_main():
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            if parallel.in_group():
                print(f"data parallel: rank {parallel.rank()} of {world} "
                      f"({torch.distributed.get_backend()})")
            check_spatial(world, spatial)
            if spatial > 1:
                parallel.set_grid(parallel.get_grid(spatial))
                print(f"spatial partitioning: a ({world // spatial}, {spatial}) "
                      "(data, spatial) grid; each image's rows split over "
                      f"{spatial} columns")
            set_bn_mode(world, args.bn_per_replica, spatial)
            check_mesh_batch(world // spatial, args.batch_size,
                             getattr(args, "val_batch_size", None))
            yield device, world
    finally:
        parallel.set_grid(None)
        if joins:
            parallel.finalize_distributed()


def resolve_tap(taps, layer):
    """The feature tap named ``layer`` from a model's ``taps`` dict; raises
    with the available names otherwise.  Shared by feature extraction and
    serving, so that both resolve taps alike."""
    if layer not in taps:
        raise ValueError(f"No feature tap named {layer!r}; available: {sorted(taps)}")
    return taps[layer]


def forward_tap(model, images, layer=None, pick=None):
    """The model's output at tap ``layer`` (avg_pool / embedding / l2norm /
    prob / softmax), or its final output with ``layer=None``; of a
    multi-output model (embedding, prob) the embedding unless ``pick``
    selects another element."""
    if layer is None:
        out = model(images)
        if isinstance(out, tuple):
            out = out[0 if pick is None else pick]
        return out
    taps = {}
    model(images, taps=taps)
    return resolve_tap(taps, layer)


@torch.inference_mode()
def extract_by_tap(model, prepare, batches, device, layer=None, train_branch=False,
                   pick=None, seed=0, autocast_dtype=None):
    """Features at a named tap for every batch, in order, masked by the
    batches' ``valid`` and fetched from the device once; the eval-mode
    counterpart of the reference's ``--layer`` sub-model extraction.

    ``prepare(raw, rng, train)`` turns a raw batch into images on
    ``device``.  With ``train_branch=True`` the augmentation draws from one
    ``torch.Generator`` seeded with ``seed`` that advances batch by batch,
    so repeated passes over the data see fresh augmentations.
    ``autocast_dtype`` (``torch.bfloat16`` for ``--bf16``) runs the forward
    under autocast; features come back as f32.  In a process group each
    rank takes its rows of every batch and every rank gets all the rows
    back (:func:`..parallel.gather_rows`).
    """
    rng = torch.Generator(device=device).manual_seed(seed)
    model.eval()
    chunks, valids = [], []
    for raw in batches:
        local = parallel.shard_batch(raw)
        images, _ = prepare(local, rng, train_branch)
        images = parallel.constrain_spatial(images)
        with maybe_autocast(device, autocast_dtype):
            feats = forward_tap(model, images, layer, pick).float()
        start, _, n = parallel.local_rows(local, feats.shape[0])
        chunks.append(parallel.gather_rows(feats, n, start))
        valids.append(np.asarray(raw["valid"]) > 0 if "valid" in raw
                      else np.ones(n, dtype=bool))
    fetched = torch.cat(chunks).cpu().numpy()
    return fetched[np.concatenate(valids)]


def load_checkpoint_raw(path):
    """``(weights, metadata)`` of a checkpoint: a ``state_dict`` and the
    metadata.  A file of the port (a ``--model_dump`` / ``--snapshot``, or
    a ``--weight_dump``: a bare ``state_dict`` with no metadata) gives its
    own; a JAX package model dump or snapshot gives its Flax variables under
    the port's names and layouts (``convert.flax_tree_to_state_dict``) and
    its metadata as the JAX package wrote it."""
    from .. import convert
    from ..train.state import checkpoint_format, read_jax_checkpoint

    fmt = checkpoint_format(path)
    if fmt == "jax_checkpoint":
        state, meta = read_jax_checkpoint(path)
        return convert.flax_tree_to_state_dict(
            {"params": state.get("params", {}),
             "batch_stats": state.get("batch_stats", {})}), meta
    if fmt == "jax_weights":
        raise ValueError(f"{path} is a JAX package weight dump (params only, no BatchNorm "
                         "statistics or metadata); rebuild a model from its model dump, or "
                         "load the weights by name (--finetune, --init_weights)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in payload and isinstance(payload["model"], dict):
        return payload["model"], payload.get("metadata", {})
    return payload, {}


def _input_channels(state_dict, build):
    """The image channels a checkpoint's model takes: those of its stem's
    weight, the first conv weight of the model ``build(3)`` makes on the
    meta device (every model registers its network first, and its stem
    first in it), whatever the family names it.  The checkpoint's own order
    does not tell: a JAX package tree comes back with sorted names."""
    with torch.device("meta"):
        probe = build(3)
    for key, value in probe.state_dict().items():
        if value.ndim == 4:
            return int(state_dict[key].shape[1])
    raise ValueError("Checkpoint has no conv weight in its network")


def _build_from_metadata(weights, meta, arch, path, channels):
    """The model a checkpoint's weights and metadata describe, built with
    ``channels`` input channels (weights not loaded yet)."""
    from ..models import CenterLossModel, LabelEmbedModel
    from ..train.state import has_backbone

    generator = torch.Generator().manual_seed(0)  # any init: the dump overwrites it

    def width(name):
        """Output width of a dense layer, or None where it is absent."""
        value = weights.get(name)
        return None if value is None else int(value.shape[0])

    if not has_backbone(weights):  # a classifier: the bare network
        top = width("top.weight")
        if top is None:
            raise ValueError(f"Cannot infer the classifier output width of {path}")
        return build_network(top, arch, classification=True, input_channels=channels,
                             generator=generator).module
    embed_dim = meta.get("embed_dim")
    if embed_dim is None:
        embed_dim = width("backbone.top.weight") or 0
    learner = meta.get("learner")
    if learner is not None:
        backbone = build_network(embed_dim, arch, input_channels=channels,
                                 generator=generator).module
        classes = width("prob_head.weight")
        if learner == "labelembed":
            return LabelEmbedModel(backbone, classes, generator)
        if learner == "center_loss":
            return CenterLossModel(backbone, classes, embed_dim, generator=generator)
        raise ValueError(f"Checkpoint {path} names an unknown learner {learner!r}")
    if "loss" not in meta:
        import warnings

        warnings.warn(
            f"Checkpoint {path} lacks 'loss' metadata; assuming 'inv_corr' "
            "(l2norm output).", RuntimeWarning)
    cls_classes = meta.get("cls_classes", 0)
    if not cls_classes:
        cls_classes = width("cls_top.weight") or 0
    model, _ = build_embedding_model(
        embed_dim, arch, meta.get("loss", "inv_corr"), cls_classes,
        input_channels=channels, cls_base=meta.get("cls_base"))
    return model


def rebuild_model_from_checkpoint(path, device, architecture=None):
    """Loads a model dump and rebuilds the module from its metadata, on
    ``device`` in eval mode: an embedding model (the embedding width, loss,
    classification head and its ``cls_base`` that the trainer records), a
    baseline learner's model (``learner`` in the metadata), or a classifier
    (a bare network with a softmax ``top``, whose width gives the classes).
    A JAX package model dump rebuilds the same way from its metadata as the
    JAX package wrote it.  bf16 is the caller's ``torch.autocast``; the
    weights stay f32.  Returns ``(model, metadata)``.
    """
    weights, meta = load_checkpoint_raw(path)
    arch = meta.get("architecture") or architecture
    if arch is None:
        raise ValueError(f"Checkpoint {path} has no architecture metadata; pass "
                         "--architecture.")

    def build(channels):
        return _build_from_metadata(weights, meta, arch, path, channels)

    model = build(_input_channels(weights, build))
    model.load_state_dict(weights, strict=True)
    return model.to(device).eval(), meta


def metrics_logger(args):
    """The ``--log_dir`` logger, on rank 0 only (None elsewhere, or without
    the flag)."""
    return MetricsLogger(args.log_dir) if args.log_dir and parallel.is_main() else None


class MetricsLogger:
    """Per-epoch metrics log for ``--log_dir``: ``metrics.jsonl``, one JSON
    object per epoch, and TensorBoard scalar events (``epoch_<metric>`` at
    step ``epoch``, the reference's ``keras.callbacks.TensorBoard`` tags)
    through ``torch.utils.tensorboard`` where the ``tensorboard`` package
    imports; without it the JSONL alone, as the JAX package's logger falls
    back.  The directory is recreated at start."""

    def __init__(self, log_dir):
        import shutil

        if os.path.isdir(log_dir):
            shutil.rmtree(log_dir, ignore_errors=True)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: JSONL only
            return
        self._tb = SummaryWriter(log_dir)

    def __call__(self, epoch, metrics):
        vals = {k: float(v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **vals}) + "\n")
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(f"epoch_{k}", v, epoch)
            self._tb.flush()
