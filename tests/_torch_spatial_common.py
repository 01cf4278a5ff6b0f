"""The rank side of ``tests/test_torch_spatial.py``, and the one-process runs
it is held against.

:func:`run` is what each of the four processes that ``parallel.launch``
spawns calls: it joins a gloo group on the CPU, and for every case of a
pickled description folds the four ranks into the case's ``(data, spatial)``
grid and runs it; rank 0 pickles the results.  :func:`run_case` with no
group runs a case in one process.  torch only: the JAX side of each
comparison runs in the test's own process.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from semantic_embeddings_torch import parallel
from semantic_embeddings_torch.cli import common
from semantic_embeddings_torch.data import SyntheticDataset, augment
from semantic_embeddings_torch.models import EmbeddingModel, ModelSpec, build_network
from semantic_embeddings_torch.models import layers as L
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.models.densenet import DenseNetFCN
from semantic_embeddings_torch.models.nasnet import NASNetA
from semantic_embeddings_torch.train import (
    fit,
    make_classifier_eval_step,
    make_classifier_train_step,
    make_eval_step,
    make_train_step,
    new_train_state,
    run_validation,
)
from semantic_embeddings_torch.train.schedules import PiecewiseSchedule

CLASSES = 8


def _t(a):
    return torch.from_numpy(np.asarray(a))


def backbone(case):
    """The case's network (and its L2 filters): the JAX spatial test's
    ``simple`` and ``resnet-110-fc`` (n = 1), or one of the port's own:
    rn18, a NASNet-A of one cell a stage, a DenseNet FCN."""
    arch, kind = case["arch"], case.get("kind", "embedding")
    g = torch.Generator().manual_seed(0)
    if arch == "resnet-110-fc-n1":
        module = SmallResNet(n=1, filters=(16, 32, 64), classes=CLASSES, include_top=True,
                             remat=case.get("remat", False))
        return ModelSpec(arch, module, [(r".*", 2e-4)], 16)
    if arch == "nasnet-tiny":
        module = NASNetA(classes=CLASSES, num_normal_cells=1, penultimate_filters=24 * 4,
                         stem_filters=8, generator=g)
        return ModelSpec(arch, module, [(r".*", 5e-5)], 32)
    if arch == "fcn-tiny":
        module = DenseNetFCN(classes=CLASSES, nb_dense_block=2, growth_rate=4,
                             layers_per_block=2, init_conv_filters=8,
                             upsampling_type=case.get("upsampling", "deconv"), generator=g)
        return ModelSpec(arch, module, [(r".*", 1e-4)], 16)
    return build_network(CLASSES, arch, classification=kind == "classifier", generator=g,
                         remat=case.get("remat", False))


def model_of(case):
    """(model, spec), the case's weights loaded."""
    spec = backbone(case)
    kind = case.get("kind", "embedding")
    model = spec.module if kind in ("classifier", "fcn") else EmbeddingModel(
        spec.module, output="l2norm")
    if "state" in case:
        model.load_state_dict({k: _t(v) for k, v in case["state"].items()})
    return model.to(case.get("dtype", torch.float32)), spec


def _prepare(case, dataset):
    """The dataset's prepare, with the case's augmentation parameters
    (``ty`` ...) applied where the raw batch carries them, in the case's
    dtype."""
    base = dataset.make_prepare("cpu", augment_train=False)
    dtype = case.get("dtype", torch.float32)
    xtr = _t(dataset._x_train_host)

    def prepare(raw, rng, train):
        images, labels = base(raw, rng, train)
        if train and "ty" in raw:
            imgs = augment.affine_apply(
                xtr[_t(raw["idx"]).long()].float(),
                *(_t(raw[k]) for k in ("ty", "tx", "zy", "zx", "flip")))
            images = (imgs - _t(dataset.mean)) / _t(dataset.std)
        return images.to(dtype), labels

    return prepare


def _state_out(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def run_case(case):
    """One case on this process's grid (or alone): the results rank 0
    reports."""
    L.set_default_bn_groups(case.get("bn_groups", 1))
    try:
        return RUNNERS[case["runner"]](case)
    finally:
        L.set_default_bn_groups(1)


def _dataset(case):
    return SyntheticDataset(num_classes=CLASSES, n_train=64, n_test=32,
                            size=case.get("size", 16))


def _shard_mean(value):
    """The mean over the data shards of a metric every rank of a shard holds
    (the shard's), i.e. the global batch's; the value alone."""
    if parallel.world_size() == 1:
        return float(value)
    total = parallel.sum_over_group(torch.as_tensor(value, dtype=torch.float64))
    return float(total) / parallel.world_size()


def _step(case):
    """One train step from the case's weights on its batch: the global
    loss, the state, and (``grads``) the gradients, summed over the ranks
    and divided by the data shards, with no clip and no update."""
    model, spec = model_of(case)
    dataset = _dataset(case)
    prepare = _prepare(case, dataset)
    kind = case.get("kind", "embedding")
    if kind == "classifier":
        step = make_classifier_train_step(model, prepare, num_classes=CLASSES,
                                          l2_penalty_fn=spec.l2_penalty,
                                          clipnorm=case.get("clipnorm", 10.0))
    else:
        step = make_train_step(
            model, prepare, loss_name="inv_corr",
            class_embedding=np.eye(CLASSES, dtype=np.float32),
            l2_penalty_fn=spec.l2_penalty, clipnorm=case.get("clipnorm", 10.0),
            autocast_dtype=torch.bfloat16 if case.get("bf16") else None)
    raw = parallel.shard_batch(case["batch"])
    state = new_train_state(model)
    out = {}
    if case.get("grads"):
        # the gradients finish_step forms: catch them before the update
        from semantic_embeddings_torch.train import trainer

        seen = {}
        reduce = parallel.reduce_gradients

        def keep(grads):
            reduce(grads)
            seen["grads"] = [g.detach().clone() for g in grads]
            return grads

        trainer.parallel.reduce_gradients = keep
        try:
            state, m = step(state, raw, case.get("lr", 0.1), None)
        finally:
            trainer.parallel.reduce_gradients = reduce
        names = [n for n, _ in model.named_parameters()]
        out["grads"] = {n: g.numpy() for n, g in zip(names, seen["grads"])}
    else:
        state, m = step(state, raw, case.get("lr", 0.1), None)
    out["loss"] = _shard_mean(m["loss"])
    out["state"] = _state_out(model)
    return out


def _eval(case):
    """The eval step's summed metrics over one test batch, added over the
    data shards."""
    model, spec = model_of(case)
    dataset = _dataset(case)
    prepare = dataset.make_prepare("cpu")
    if case.get("kind") == "classifier":
        step = make_classifier_eval_step(model, prepare, num_classes=CLASSES)
    else:
        step = make_eval_step(model, prepare, loss_name="inv_corr",
                              class_embedding=np.eye(CLASSES, dtype=np.float32))
    raw = next(iter(dataset.test_batches(case["batch_size"])))
    m = step(new_train_state(model), parallel.shard_batch(raw), None)
    m.pop("pred", None)
    grid = parallel.current_grid()
    return {k: float(parallel.sum_over_group(
        torch.as_tensor(v, dtype=torch.float64),
        group=None if grid is None else grid.data_group)) for k, v in m.items()}


def _fit(case):
    """``fit`` for the case's epochs: the state and the logged metrics."""
    model, spec = model_of(case)
    dataset = _dataset(case)
    prepare = dataset.make_prepare("cpu", augment_train=False)
    emb = np.eye(CLASSES, dtype=np.float32)
    train_step = make_train_step(model, prepare, loss_name="inv_corr", class_embedding=emb,
                                 l2_penalty_fn=spec.l2_penalty, clipnorm=10.0)
    eval_step = make_eval_step(model, prepare, loss_name="inv_corr", class_embedding=emb)
    logged = []
    state = fit(new_train_state(model), train_step, eval_step, dataset,
                PiecewiseSchedule([(0, 0.1)]), epochs=case["epochs"], batch_size=32,
                verbose=False, log_fn=lambda e, m: logged.append(m))
    final = run_validation(eval_step, state, dataset.test_batches(32, **common.sharded()),
                           None)
    final.pop("predictions", None)
    return {"state": _state_out(model), "logged": logged, "final": final}


def _features(case):
    """The feature dump's extraction: every test image's embedding."""
    model, _ = model_of(case)
    dataset = _dataset(case)
    return {"features": common.extract_test_features(model, dataset, torch.device("cpu"),
                                                     batch_size=16)}


def _fcn(case):
    """One forward and backward of the DenseNet FCN (training mode): its
    whole output map and the gradients of sum(out * r), and the running
    statistics."""
    model, _ = model_of(case)
    model.train()
    x = _t(case["x"]).to(case.get("dtype", torch.float32))
    r = _t(case["r"]).to(x.dtype)
    n = x.shape[0]
    start, stop = parallel.process_slice(n)
    images = parallel.constrain_spatial(x[start:stop])
    out = model(images)  # NHWC, this rank's rows
    h = x.shape[1]
    a, b = (0, h) if not parallel.spatial.active() else parallel.spatial.block(h)
    loss = (out * r[start:stop, a:b]).sum()
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params)
    grads = [parallel.sum_over_group(g) for g in grads]
    # every (image, row) of the output lies on one rank: a sum gathers it
    full = torch.zeros((n, h) + tuple(out.shape[2:]), dtype=out.dtype)
    full[start:stop, a:b] = out.detach()
    full = parallel.sum_over_group(full)
    names = [name for name, _ in model.named_parameters()]
    return {"out": full.numpy(), "grads": {k: g.numpy() for k, g in zip(names, grads)},
            "state": _state_out(model)}


def _pools(case):
    """The whole-map reductions of a row block (f64): global max and
    average pooling and the flatten's gather, and the gradient of a loss of
    all three with respect to the map, whose every row lies on one rank
    (the loss taken 1 / S on each of the S columns, as the train step
    takes it)."""
    x = _t(case["x"])  # (N, C, H, W)
    n, _, h, _ = x.shape
    spatial = parallel.spatial.spatial_size()
    rows = parallel.constrain_spatial(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    rows = rows.contiguous().requires_grad_(True)
    if parallel.spatial.active():
        parallel.spatial.record(rows, h)
    outs = [L.global_max_pool(rows), L.global_avg_pool(rows), L.flatten_nhwc(rows)]
    loss = sum((o * _t(r)).sum() for o, r in zip(outs, case["r"])) / spatial
    (grad,) = torch.autograd.grad(loss, [rows])
    a, b = (0, h) if not parallel.spatial.active() else parallel.spatial.block(h)
    full = torch.zeros_like(x)
    full[:, :, a:b] = grad
    return {"outs": [o.detach().numpy() for o in outs],
            "grad": parallel.sum_over_group(full).numpy()}


RUNNERS = {"step": _step, "eval": _eval, "fit": _fit, "features": _features, "fcn": _fcn,
           "pools": _pools}


def run(case_path, out_path):
    """Rank side: join the group, run every case on its grid, rank 0 writes
    the results."""
    torch.set_num_threads(1)
    parallel.initialize_distributed("cpu")
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    grids, results = {}, {}
    for name, case in cases.items():
        spatial = case["spatial"]
        if spatial not in grids:  # every rank makes every group, in one order
            grids[spatial] = parallel.get_grid(spatial)
        parallel.set_grid(grids[spatial])
        try:
            results[name] = run_case(case)
        finally:
            parallel.set_grid(None)
    if parallel.rank() == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    parallel.finalize_distributed()
