"""The rank side of ``tests/test_torch_parallel.py``.

:func:`run` is what each of the processes that ``parallel.launch`` spawns
calls: it joins a gloo group on the CPU from the launcher's environment,
runs the cases of a pickled description on its rows of every global batch,
and rank 0 pickles the results.  torch only: the JAX side of each
comparison runs in the test's own process.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch

from semantic_embeddings_torch import convert, parallel
from semantic_embeddings_torch.models import ModelSpec
from semantic_embeddings_torch.models import layers as L
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.models.heads import EmbeddingModel
from semantic_embeddings_torch.models.learners import CenterLossModel, LabelEmbedModel
from semantic_embeddings_torch.models.resnet import BottleneckBlock
from semantic_embeddings_torch.ops import fused_cosine_loss
from semantic_embeddings_torch.train import (
    make_classifier_train_step,
    make_train_step,
    new_train_state,
    special,
)
from semantic_embeddings_torch.data import augment

FILTERS = [(r"^cls_top$", 5e-4), (r".*", 2e-4)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _block(case):
    """One BottleneckBlock (projection shortcut) in training mode with sync
    BN: its output, input gradient and summed parameter gradients of
    sum(y * r) over the global batch, and its running statistics."""
    block = BottleneckBlock(case["in_features"], case["features"], project=True)
    block.load_state_dict({k: _t(v) for k, v in case["state"].items()})
    block.train()
    n = case["x"].shape[0]
    start, stop = parallel.process_slice(n)
    x = _t(case["x"][start:stop]).requires_grad_(True)
    y = block(x)
    loss = (y * _t(case["r"][start:stop])).sum()
    params = [p for _, p in block.named_parameters()]
    grads = torch.autograd.grad(loss, [x] + params)
    return {
        "y": parallel.gather_rows(y.detach(), n, start).numpy(),
        "dx": parallel.gather_rows(grads[0], n, start).numpy(),
        "dparams": {name: parallel.sum_over_group(g).numpy()
                    for (name, _), g in zip(block.named_parameters(), grads[1:])},
        "state": {k: v.numpy() for k, v in block.state_dict().items()},
    }


def _model(case):
    """The case's model from its state dict, its step and its prepare."""
    kind, arch = case["kind"], case["arch"]
    backbone = SmallResNet(**arch)
    spec = ModelSpec("x", backbone, FILTERS)
    if kind == "embedding":
        model = EmbeddingModel(backbone, output="l2norm", cls_classes=case["classes"])
    elif kind == "classifier":
        model = backbone
    elif kind == "center_loss":
        model = CenterLossModel(backbone, case["classes"], arch["classes"])
    else:
        model = LabelEmbedModel(backbone, case["classes"])
    model.load_state_dict({k: _t(v) for k, v in case["state"].items()})
    l2 = spec.l2_penalty if kind in ("embedding", "classifier") else (
        lambda m: spec.l2_penalty(m.backbone))
    if kind == "embedding":
        xtr, ytr = _t(case["x_train"]), _t(case["y_train"]).long()
        mean, std = _t(case["mean"]), _t(case["std"])

        def prepare(raw, rng, train):
            idx = _t(raw["idx"]).long()
            imgs = augment.affine_apply(
                xtr[idx].float(), *(_t(raw[k]) for k in ("ty", "tx", "zy", "zx", "flip")))
            return (imgs - mean) / std, ytr[idx]

        step = make_train_step(
            model.twin("linear", cls_input="l2norm"), prepare, loss_name="inv_corr",
            class_embedding=case["embedding"], num_classes=case["classes"], cls_weight=0.1,
            l2_penalty_fn=l2, clipnorm=1.0,
            loss_fn_override=lambda tgt, z: fused_cosine_loss(z, tgt))
        return model, step

    def prepare(raw, rng, train):
        return _t(raw["x"]), _t(raw["y"]).long()

    if kind == "classifier":
        step = make_classifier_train_step(model, prepare, num_classes=case["classes"],
                                          label_smoothing=0.1, l2_penalty_fn=l2,
                                          clipnorm=1.0)
    elif kind == "center_loss":
        step = special.make_center_loss_train_step(
            model, prepare, num_classes=case["classes"], l2_penalty_fn=l2, clipnorm=1.0)
    else:
        step = special.make_labelembed_train_step(model, prepare, l2_penalty_fn=l2,
                                                  clipnorm=1.0)
    return model, step


def _steps(case):
    """The case's train steps on this rank's rows of each global batch
    (BatchNorm in ``case['bn_groups']`` groups): the metrics of each step,
    the final state in the JAX tree's layout, and whether every rank ended
    with the same state."""
    L.set_default_bn_groups(case["bn_groups"])
    try:
        model, step = _model(case)
        state = new_train_state(model)
        metrics = []
        for raw, lr in zip(case["batches"], case["lrs"]):
            state, m = step(state, parallel.shard_batch(raw), lr, None)
            metrics.append({k: float(parallel.sum_over_group(v.float()) / parallel.world_size())
                            for k, v in m.items()})
    finally:
        L.set_default_bn_groups(1)
    flat = torch.cat([v.reshape(-1).float() for v in model.state_dict().values()])
    spread = parallel.sum_over_group((flat - parallel.sum_over_group(flat)
                                      / parallel.world_size()).abs().max())
    return {"metrics": metrics, "variables": convert.state_dict_to_flax(model),
            "ranks_agree": float(spread) == 0.0}


RUNNERS = {"block": _block, "steps": _steps}


# -- on the card (tests/test_torch_cuda.py) ------------------------------------


def cuda_model(seed):
    """rn18 embedding 10 dims at 32 px with a 10-way head, on the card."""
    from semantic_embeddings_torch.models import build_network

    g = torch.Generator().manual_seed(seed)
    spec = build_network(10, "rn18", generator=g)
    model = EmbeddingModel(spec.module, output="l2norm", cls_classes=10, generator=g)
    return model.to("cuda"), spec


def cuda_step(model, spec, prepare, plain=False):
    """The --fused_loss step of :func:`cuda_model`'s model, through the
    cosine kernels or (``plain``, any dtype) their plain version."""
    from semantic_embeddings_torch.ops.cosine_loss import PlainCosineLoss

    return make_train_step(
        model.twin("linear", cls_input="l2norm"), prepare, loss_name="inv_corr",
        class_embedding=np.eye(10, dtype=np.float32), num_classes=10, cls_weight=0.1,
        l2_penalty_fn=spec.l2_penalty, clipnorm=10.0,
        loss_fn_override=((lambda tgt, z: PlainCosineLoss.apply(z, tgt)) if plain
                          else (lambda tgt, z: fused_cosine_loss(z, tgt))))


def cuda_fit_alone_and_grouped(out_path):
    """Two steps through ``fit`` on the card without a group, then in the
    NCCL group of one rank the launcher's environment gives, from the same
    weights (deterministic cuDNN): whether every tensor is bitwise equal,
    and the launches of each run."""
    from semantic_embeddings_torch.data import SyntheticDataset
    from semantic_embeddings_torch.ops import conv3x3 as CC
    from semantic_embeddings_torch.train import fit, get_lr_schedule, make_eval_step

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    data = SyntheticDataset(num_classes=10, n_train=32, n_test=16, size=32)

    def run():
        model, spec = cuda_model(0)
        prepare = data.make_prepare("cuda")
        eval_step = make_eval_step(model, prepare, class_embedding=np.eye(10, dtype=np.float32),
                                   num_classes=10, cls_weight=0.1)
        CC.launches_conv_bn_stats = CC.launches_filter_grad = 0
        state = fit(new_train_state(model), cuda_step(model, spec, prepare), eval_step, data,
                    get_lr_schedule("SGD", 32, 16)[0], epochs=1, batch_size=16,
                    verbose=False)
        torch.cuda.synchronize()
        return ({k: v.cpu() for k, v in state.model.state_dict().items()},
                [CC.launches_conv_bn_stats, CC.launches_filter_grad])

    alone = run()
    parallel.initialize_distributed("cuda")
    backend = torch.distributed.get_backend()
    grouped = run()
    parallel.finalize_distributed()
    with open(out_path, "wb") as f:
        pickle.dump({"backend": backend, "launches": [alone[1], grouped[1]],
                     "unequal": [k for k in alone[0]
                                 if not torch.equal(alone[0][k], grouped[0][k])]}, f)


def cuda_two_ranks_step(case_path, out_path):
    """One step on each of two gloo ranks on cuda:0 (NCCL takes one rank a
    card) from the case's weights, each on its half of the batch: rank 0
    writes the state, the launches, and whether both ranks ended equal."""
    from semantic_embeddings_torch.ops import conv3x3 as CC

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    parallel.initialize_distributed("cuda", backend="gloo")
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    model, spec = cuda_model(0)
    model.load_state_dict({k: _t(v) for k, v in case["state"].items()})

    def prepare(raw, rng, train):
        return _t(raw["x"]).cuda(), _t(raw["y"]).long().cuda()

    CC.launches_conv_bn_stats = CC.launches_filter_grad = 0
    state, _ = cuda_step(model, spec, prepare)(
        new_train_state(model), parallel.shard_batch(case["batch"]), 0.1, None)
    torch.cuda.synchronize()
    flat = torch.cat([v.reshape(-1).float() for v in state.model.state_dict().values()])
    spread = parallel.sum_over_group(
        (flat - parallel.sum_over_group(flat) / parallel.world_size()).abs().max())
    if parallel.rank() == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"state": {k: v.cpu().numpy()
                                   for k, v in state.model.state_dict().items()},
                         "launches": [CC.launches_conv_bn_stats, CC.launches_filter_grad],
                         "ranks_equal": float(spread) == 0.0}, f)
    parallel.finalize_distributed()


def report_threads(out):
    """Rank side: writes the rank's torch thread count to ``out/rank{r}``."""
    (Path(out) / f"rank{os.environ['RANK']}").write_text(str(torch.get_num_threads()))


def run(case_path, out_path):
    """Rank side: join the group, run every case, rank 0 writes results."""
    parallel.initialize_distributed("cpu")
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    results = {name: RUNNERS[case["runner"]](case) for name, case in cases.items()}
    if parallel.rank() == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    parallel.finalize_distributed()
