"""The port's data parallelism against the JAX package's mesh.

Training ranks run in processes of their own (``parallel.launch``: two gloo
ranks on the CPU, ``tests/_torch_parallel_common.py``), each on its rows of
every global batch; the JAX side runs here on ``get_mesh(2)`` of the
conftest's host devices, whose run is numerically the single-device run on
the global batch.  Tolerance: f32 sums taken in another order (the group's
sums, the sharded reductions) compound over the layers, the backward and
the updates to ~1e-5 relative; rtol 1e-4, as ``test_torch_train.py``.
Retrieval and serving run one process over a list of devices, here CPUs.
"""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import _torch_parallel_common as ranks
from semantic_embeddings_tpu.cli import common as jcommon
from semantic_embeddings_tpu.data import augment as jaugment
from semantic_embeddings_tpu.data.cifar import SyntheticDataset as JSyntheticDataset
from semantic_embeddings_tpu.evaluation import retrieval as jretrieval
from semantic_embeddings_tpu.models import ModelSpec as JModelSpec
from semantic_embeddings_tpu.models import layers as JL
from semantic_embeddings_tpu.models.cifar_resnet import SmallResNet as JSmallResNet
from semantic_embeddings_tpu.models.heads import EmbeddingModel as JEmbeddingModel
from semantic_embeddings_tpu.models.learners import CenterLossModel as JCenterLossModel
from semantic_embeddings_tpu.models.learners import LabelEmbedModel as JLabelEmbedModel
from semantic_embeddings_tpu.models.resnet import BottleneckBlock as JBottleneckBlock
from semantic_embeddings_tpu.ops import fused_cosine_loss as jfused
from semantic_embeddings_tpu.parallel import get_mesh, replicate
from semantic_embeddings_tpu.parallel import process_slice as jprocess_slice
from semantic_embeddings_tpu.parallel import shard_batch as jshard_batch
from semantic_embeddings_tpu.train import make_classifier_train_step as jclassifier_step
from semantic_embeddings_tpu.train import make_train_step as jmake_train_step
from semantic_embeddings_tpu.train import new_train_state as jnew_train_state
from semantic_embeddings_tpu.train import special as jspecial
from semantic_embeddings_torch import convert, parallel
from semantic_embeddings_torch.cli import common as tcommon
from semantic_embeddings_torch.cli import evaluate_retrieval as tretrieval_cli
from semantic_embeddings_torch.cli import learn_image_embeddings
from semantic_embeddings_torch.embeddings.io import load_features
from semantic_embeddings_torch.evaluation import retrieval as tretrieval
from semantic_embeddings_torch.models import layers as TL
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.models.heads import EmbeddingModel
from semantic_embeddings_torch.models.learners import CenterLossModel, LabelEmbedModel
from semantic_embeddings_torch.models.resnet import BottleneckBlock
from semantic_embeddings_torch.serving import BatchingEngine

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _randomize(variables, seed):
    """Non-trivial BN scales, biases and running statistics."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables.get(coll, {}))[0]:
            name = path[-1].key
            if name in ("scale", "var"):
                leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
            elif name in ("bias", "mean"):
                leaf[...] = rng.normal(0, 0.2, leaf.shape)
    return variables


def _assert_tree(got, want, what):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL, err_msg=f"{what} {path}")


# -- pure arithmetic and messages --------------------------------------------


def test_process_slice_matches_jax():
    for n, count in ((256, 4), (8, 1), (16, 2), (6, 3)):
        for index in range(count):
            assert parallel.process_slice(n, index, count) == jprocess_slice(n, index, count)
    with pytest.raises(ValueError) as ours:
        parallel.process_slice(10, 0, 4)
    with pytest.raises(ValueError) as ref:
        jprocess_slice(10, 0, 4)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("bn_per_replica", [False, True])
def test_resolve_mesh_messages_match_jax(capsys, bn_per_replica):
    """Asking for more devices than present, and the sync-BN NOTE or the
    per-replica line, word for word; 8 present, as the conftest's host
    devices are for the JAX package."""
    try:
        jcommon.resolve_mesh(16, bn_per_replica=bn_per_replica)
        ref = capsys.readouterr().out
        assert tcommon.resolve_mesh(16, bn_per_replica=bn_per_replica, available=8) == 8
        assert capsys.readouterr().out == ref
        assert "Requested 16 devices but only 8 present; using 8." in ref
        assert ("per-replica statistics over 8 shards" in ref) == bn_per_replica
        assert TL.DEFAULT_BN_GROUPS == (8 if bn_per_replica else 1)
        jcommon.resolve_mesh(1, bn_per_replica=bn_per_replica)
        tcommon.resolve_mesh(1, bn_per_replica=bn_per_replica, available=8)
        assert capsys.readouterr().out == ""
    finally:
        JL.set_default_bn_groups(1)
        TL.set_default_bn_groups(1)


@pytest.mark.parametrize("bn_per_replica", [False, True])
@pytest.mark.parametrize("gpus,spatial", [(8, 4), (8, 2), (4, 4), (3, 2), (1, 2)])
def test_resolve_with_spatial_matches_jax(capsys, bn_per_replica, gpus, spatial):
    """``resolve_mesh`` with ``--spatial``: JAX's messages word for word (the
    refusal, the BN note over the data shards, the per-replica line), and
    its BatchNorm groups (one a data shard under ``--bn_per_replica``)."""
    def outcome(resolve):
        try:
            resolve()
        except SystemExit as e:
            return "exit: " + str(e), capsys.readouterr().out
        return TL.DEFAULT_BN_GROUPS if resolve is ours else JL.DEFAULT_BN_GROUPS, \
            capsys.readouterr().out

    def ours():
        tcommon.resolve_mesh(gpus, bn_per_replica=bn_per_replica, available=8,
                             spatial=spatial)

    try:
        ref = outcome(lambda: jcommon.resolve_mesh(gpus, bn_per_replica=bn_per_replica,
                                                   spatial=spatial))
        assert outcome(ours) == ref
        if gpus % spatial:
            assert f"--spatial {spatial} must divide the device count ({gpus})" in ref[0]
    finally:
        JL.set_default_bn_groups(1)
        TL.set_default_bn_groups(1)


# -- grouped BatchNorm in one process -----------------------------------------


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_batchnorm_matches_jax(groups):
    """``_GroupedBatchNorm`` at 1, 2 and 4 groups: the training forward, the
    gradients of sum(y * r) and the running statistics (the whole batch's
    moments: mean of the group means, law of total variance) against the
    JAX module's, and its eval forward."""
    rng = np.random.default_rng(groups)
    x = rng.normal(1.5, 2.0, (16, 4, 4, 3)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    jbn = JL._GroupedBatchNorm(groups=groups)
    variables = _randomize(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x)), groups)

    def jloss(params, x):
        y, mut = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           x, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, mut)

    (jgp, jgx), (jy, mut) = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    tbn = TL._GroupedBatchNorm(3, groups)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ty = tbn.train()(tx)
    tgx, tgw, tgb = torch.autograd.grad(
        (ty * torch.from_numpy(r).permute(0, 3, 1, 2)).sum(), [tx, tbn.weight, tbn.bias])
    nhwc = (0, 2, 3, 1)
    np.testing.assert_allclose(ty.detach().permute(*nhwc).numpy(), np.asarray(jy),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(tgx.permute(*nhwc).numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgb.numpy(), np.asarray(jgp["bias"]), rtol=1e-5, atol=1e-5)
    for ours, key in ((tbn.running_mean, "mean"), (tbn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(mut["batch_stats"][key]),
                                   rtol=0, atol=1e-6, err_msg=key)
    jeval = jbn.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                      jnp.asarray(x), train=False)
    with torch.no_grad():
        teval = tbn.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(teval.permute(*nhwc).numpy(), np.asarray(jeval), rtol=0,
                               atol=2e-5)


def test_keras_batchnorm_groups_default_follows_set_default_bn_groups():
    """A KerasBatchNorm that pins no groups takes the default at each
    forward: 2 groups normalize each half of the batch on its own."""
    x = torch.from_numpy(np.random.default_rng(0).normal(1.0, 3.0, (8, 3, 2, 2))
                         .astype(np.float32))
    bn = TL.KerasBatchNorm(3).train()
    try:
        TL.set_default_bn_groups(2)
        y = bn(x)
    finally:
        TL.set_default_bn_groups(1)
    halves = torch.cat([TL.KerasBatchNorm(3).train()(x[:4]), TL.KerasBatchNorm(3).train()(x[4:])])
    torch.testing.assert_close(y, halves, rtol=0, atol=2e-6)


# -- two gloo ranks against the JAX mesh -------------------------------------


def _embedding_case(bn_groups):
    """Three --fused_loss steps of a narrow SmallResNet (n=2, filters
    8/16/32, 16 px, batch 16) with injected augmentation parameters, as
    ``test_torch_train.py`` runs them."""
    n_cls, dim, size, batch = 10, 12, 16, 16
    ds = JSyntheticDataset(num_classes=n_cls, n_train=64, n_test=16, size=size)
    rng = np.random.default_rng(6)
    emb = _unit_rows(rng, n_cls, dim)
    batches = [{
        "idx": rng.integers(0, 64, batch).astype(np.int32),
        "ty": rng.uniform(-2.4, 2.4, batch).astype(np.float32),
        "tx": rng.uniform(-2.4, 2.4, batch).astype(np.float32),
        "zy": rng.uniform(0.9, 1.1, batch).astype(np.float32),
        "zx": rng.uniform(0.9, 1.1, batch).astype(np.float32),
        "flip": rng.random(batch) < 0.5} for _ in range(3)]
    jbackbone = JSmallResNet(n=2, filters=(8, 16, 32), classes=dim, include_top=True,
                             top_activation=None)
    jtrain = JEmbeddingModel(backbone=jbackbone, output="linear", cls_classes=n_cls,
                             cls_input="l2norm")
    variables = jax.device_get(jtrain.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    tmodel = EmbeddingModel(SmallResNet(n=2, filters=(8, 16, 32), classes=dim,
                                        include_top=True),
                            output="l2norm", cls_classes=n_cls)
    convert.load_flax_variables(tmodel, variables)
    xtr, ytr = jnp.asarray(ds._x_train_host), jnp.asarray(ds.labels_train)

    def jprepare(raw, key, train):
        imgs = jax.vmap(jaugment._affine_sample)(
            xtr[raw["idx"]].astype(jnp.float32), raw["ty"], raw["tx"], raw["zy"], raw["zx"],
            raw["flip"])
        return (imgs - ds.mean) / ds.std, ytr[raw["idx"]]

    def jstep():
        return jmake_train_step(
            jtrain, jprepare, loss_name="inv_corr", class_embedding=emb, num_classes=n_cls,
            cls_weight=0.1, l2_penalty_fn=JModelSpec("x", jbackbone, ranks.FILTERS).l2_penalty,
            clipnorm=1.0, loss_fn_override=lambda tgt, z: jfused(z, tgt))

    case = {"runner": "steps", "kind": "embedding", "bn_groups": bn_groups,
            "arch": dict(n=2, filters=(8, 16, 32), classes=dim, include_top=True),
            "classes": n_cls, "embedding": emb, "x_train": ds._x_train_host,
            "y_train": ds.labels_train, "mean": ds.mean, "std": ds.std,
            "state": {k: v.numpy() for k, v in tmodel.state_dict().items()},
            "batches": batches, "lrs": [0.5, 0.2, 0.05]}
    return case, (jstep, variables)


def _learner_case(kind):
    """Two steps of a baseline learner on a narrow SmallResNet (n=1, 8 px,
    batch 12)."""
    n_cls, dim, size, batch = 6, 8, 8, 12
    top = "softmax" if kind == "classifier" else None
    classes = n_cls if kind == "classifier" else dim
    jb = JSmallResNet(n=1, filters=(4, 8, 8), classes=classes, include_top=True,
                      top_activation=top)
    tb = SmallResNet(n=1, filters=(4, 8, 8), classes=classes, include_top=True,
                     top_activation=top)
    rng = np.random.default_rng(5)
    batches = [{"x": rng.normal(size=(batch, size, size, 3)).astype(np.float32),
                "y": rng.integers(0, n_cls, batch).astype(np.int32)} for _ in range(2)]
    jl2 = JModelSpec("x", jb, ranks.FILTERS).l2_penalty
    args = (jnp.zeros((1, size, size, 3)),)
    if kind == "classifier":
        jm, tm = jb, tb
    elif kind == "center_loss":
        jm, tm = JCenterLossModel(backbone=jb, num_classes=n_cls, embed_dim=dim), \
            CenterLossModel(tb, n_cls, dim)
        args += (jnp.zeros((1,), jnp.int32),)
    else:
        jm, tm = JLabelEmbedModel(backbone=jb, num_classes=n_cls), LabelEmbedModel(tb, n_cls)
        args += (jnp.zeros((1,), jnp.int32),)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), *args, train=False))
    convert.load_flax_variables(tm, variables)

    def jprepare(raw, key, train):
        return raw["x"], raw["y"]

    def jstep():
        if kind == "classifier":
            return jclassifier_step(jm, jprepare, num_classes=n_cls, label_smoothing=0.1,
                                    l2_penalty_fn=jl2, clipnorm=1.0)
        l2 = lambda p: jl2(p["backbone"])  # noqa: E731
        if kind == "center_loss":
            return jspecial.make_center_loss_train_step(jm, jprepare, num_classes=n_cls,
                                                        l2_penalty_fn=l2, clipnorm=1.0)
        return jspecial.make_labelembed_train_step(jm, jprepare, l2_penalty_fn=l2,
                                                   clipnorm=1.0)

    case = {"runner": "steps", "kind": kind, "bn_groups": 1,
            "arch": dict(n=1, filters=(4, 8, 8), classes=classes, include_top=True,
                         top_activation=top),
            "classes": n_cls, "state": {k: v.numpy() for k, v in tm.state_dict().items()},
            "batches": batches, "lrs": [0.5, 0.2]}
    return case, (jstep, variables)


def _block_case():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16, 6, 6)).astype(np.float32)
    r = rng.normal(size=(8, 16, 6, 6)).astype(np.float32)
    jblock = JBottleneckBlock(features=4, project=True)
    variables = _randomize(jblock.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x.transpose(0, 2, 3, 1))), 4)
    tblock = BottleneckBlock(16, 4, project=True)
    convert.load_flax_variables(tblock, variables)
    case = {"runner": "block", "in_features": 16, "features": 4, "x": x, "r": r,
            "state": {k: v.numpy() for k, v in tblock.state_dict().items()}}
    return case, (jblock, variables, tblock)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case run once by two gloo ranks; ``(results, JAX sides)``."""
    cases, jax_sides = {}, {}
    cases["block"], jax_sides["block"] = _block_case()
    for name, groups in (("sync", 1), ("per_replica", 2)):
        cases[name], jax_sides[name] = _embedding_case(groups)
    for kind in ("classifier", "center_loss", "labelembed"):
        cases[kind], jax_sides[kind] = _learner_case(kind)
    tmp = tmp_path_factory.mktemp("ranks")
    with open(tmp / "cases.pickle", "wb") as f:
        pickle.dump(cases, f)
    parallel.launch(ranks.run, 2, str(tmp / "cases.pickle"), str(tmp / "out.pickle"))
    with open(tmp / "out.pickle", "rb") as f:
        return pickle.load(f), cases, jax_sides


def _jax_steps(case, jax_side, mesh):
    jstep_fn, variables = jax_side
    JL.set_default_bn_groups(case["bn_groups"])
    try:
        step = jstep_fn()
        state = replicate(mesh, jnew_train_state(variables))
        metrics = []
        for raw, lr in zip(case["batches"], case["lrs"]):
            state, m = step(state, jshard_batch(mesh, raw), lr, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        JL.set_default_bn_groups(1)
    return metrics, jax.device_get(state)


def test_sync_bn_bottleneck_block_matches_jax_mesh(two_ranks):
    """One narrow BottleneckBlock in training mode, its conv_b through the
    fused op's plain version, on two ranks with sync BN: the output, the
    input gradient, the parameter gradients and the running statistics
    against the JAX block on the 2-device mesh."""
    results, cases, jax_sides = two_ranks
    got, case = results["block"], cases["block"]
    jblock, variables, tblock = jax_sides["block"]
    mesh = get_mesh(2)
    x = jax.device_put(jnp.asarray(case["x"].transpose(0, 2, 3, 1)),
                       NamedSharding(mesh, PartitionSpec("data")))
    r = case["r"].transpose(0, 2, 3, 1)

    @jax.jit
    def grads(params, x):
        def loss(params, x):
            y, mut = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  x, train=True, mutable=["batch_stats"])
            return (y * r).sum(), (y, mut)
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(params, x)

    (gp, gx), (y, mut) = grads(variables["params"], x)
    nchw = (0, 3, 1, 2)
    np.testing.assert_allclose(got["y"], np.asarray(y).transpose(nchw), **TOL)
    np.testing.assert_allclose(got["dx"], np.asarray(gx).transpose(nchw), **TOL)
    dparams = convert.state_dict_to_flax(
        tblock, {k: torch.from_numpy(v) for k, v in got["dparams"].items()})
    _assert_tree(dparams["params"], jax.device_get(gp), "gradient")
    stats = convert.state_dict_to_flax(
        tblock, {k: torch.from_numpy(v) for k, v in got["state"].items()})
    _assert_tree(stats["batch_stats"], jax.device_get(mut["batch_stats"]), "statistics")


@pytest.mark.parametrize("name", ["sync", "per_replica", "classifier", "center_loss",
                                  "labelembed"])
def test_two_rank_steps_match_jax_mesh(two_ranks, name):
    """Train steps on two ranks, each on its half of every global batch,
    against the JAX step on the 2-device mesh: the SmallResNet --fused_loss
    recipe with sync BN and with per-replica BN (JAX: 2 BN groups), and
    the classifier, center-loss and label-embedding steps.  Every metric of
    every step and every parameter and running statistic after the last;
    the two ranks end bitwise equal."""
    results, cases, jax_sides = two_ranks
    got, case = results[name], cases[name]
    metrics, state = _jax_steps(case, jax_sides[name], get_mesh(2))
    assert got["ranks_agree"]
    for ours, ref in zip(got["metrics"], metrics):
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_tree(got["variables"]["params"], state.params, "params")
    _assert_tree(got["variables"]["batch_stats"], state.batch_stats, "batch_stats")


# -- the learner CLI on two ranks --------------------------------------------


def test_learner_cli_two_ranks_match_one_process(tmp_path, capsys):
    """``learn_image_embeddings --gpus 2 --device cpu`` spawns two ranks
    (each under a launcher's environment, gloo): its model and feature
    dumps, written by rank 0, against the one-process run at the same
    global batch; every test row in the dump once.  One step: this small
    net is chaotic at this learning rate (weights scaled by 1 + 1e-7 move
    its parameters by 8e-4 in three steps), so one step is what holds the
    two runs to rounding."""
    def argv(out, *extra):
        return ["--dataset", "synthetic-4-8-16-16", "--data_root", str(tmp_path),
                "--embedding", "onehot", "--architecture", "simple", "--batch_size", "8",
                "--epochs", "1", "--lr_schedule", "SGD", "--sgd_lr", "0.05",
                "--device", "cpu", "--model_dump", str(tmp_path / f"{out}.pt"),
                "--feature_dump", str(tmp_path / f"{out}.pickle"), *extra]

    learn_image_embeddings.main(argv("one"))
    assert learn_image_embeddings.main(argv("two", "--gpus", "2")) is None
    out = capsys.readouterr().out
    assert "spawning 2 data-parallel processes" in out
    one, _ = tcommon.load_checkpoint_raw(str(tmp_path / "one.pt"))
    two, _ = tcommon.load_checkpoint_raw(str(tmp_path / "two.pt"))
    assert sorted(one) == sorted(two)
    for k in one:
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), **TOL, err_msg=k)
    ids_one, f_one = load_features(str(tmp_path / "one.pickle"))
    ids_two, f_two = load_features(str(tmp_path / "two.pickle"))
    assert f_two.shape == (16, 4) and list(ids_two) == list(ids_one)
    np.testing.assert_allclose(f_two, f_one, **TOL)


@pytest.mark.parametrize("use_native", [True, False])
def test_file_batches_of_a_rank_are_its_rows_of_the_global_batch(tmp_path, monkeypatch,
                                                                 use_native):
    """A file dataset with ``shard=True``, as rank r of 2 sees it: each
    train and test batch holds only the rank's rows, decoded as the whole
    batch decodes them (its host draws made for the whole batch), and the
    prepare applies the rank's rows of the device draws made for the whole
    batch."""
    from _torch_files_common import write_nab

    from semantic_embeddings_torch.data import CUB_STATS
    from semantic_embeddings_torch.data.datasets import NABDataset

    write_nab(str(tmp_path), n_classes=4, per_class=4, test_every=4,
              sizes=[(30, 41), (52, 37), (44, 44), (25, 60)])
    ds = NABDataset(str(tmp_path), cropsize=(32, 28), default_target_size=36,
                    mean=CUB_STATS[0], std=CUB_STATS[1], randerase_prob=0.5)
    ds.use_native = use_native
    prepare = ds.make_prepare(CPU)
    whole = {"train": list(ds.train_batches(6, 0, 0)), "test": list(ds.test_batches(4))}
    for rank in (0, 1):
        for module in (parallel, parallel.mesh):
            monkeypatch.setattr(module, "world_size", lambda: 2)
            monkeypatch.setattr(module, "rank", lambda rank=rank: rank)
        parts = {"train": list(ds.train_batches(6, 0, 0, shard=True)),
                 "test": list(ds.test_batches(4, shard=True))}
        for kind, n in (("train", 6), ("test", 4)):
            lo, hi = rank * n // 2, (rank + 1) * n // 2
            for part, full in zip(parts[kind], whole[kind], strict=True):
                assert part["rows"] == (lo, hi, n)
                torch.testing.assert_close(part["image"], full["image"][lo:hi], rtol=0, atol=0)
                for key in set(full) - {"image"}:
                    np.testing.assert_array_equal(part[key], np.asarray(full[key])[lo:hi])
                if kind == "train":
                    ours = prepare(part, torch.Generator().manual_seed(3), True)
                    ref = prepare(full, torch.Generator().manual_seed(3), True)
                    for a, b in zip(ours, ref):
                        torch.testing.assert_close(a, b[lo:hi], rtol=0, atol=1e-5)


# -- retrieval over a list of devices ----------------------------------------


def test_db_sharded_ranking_is_the_replicated_ranking_bitwise():
    """The database's rows over 3 devices (61 rows: padded to 63), rows
    duplicated across shards for ties, the query pinned: the merged
    top-(k + 1) equals the replicated ranking, index for index."""
    rng = np.random.default_rng(11)
    feats = rng.integers(-2, 3, (61, 8)).astype(np.float32)
    feats[7] = feats[45] = feats[3]
    database = torch.from_numpy(feats)
    for normalize in (False, True):
        db = torch.nn.functional.normalize(database, dim=1) if normalize else database
        rank = tretrieval._db_sharded_ranker(db, [CPU] * 3, normalize, topk=20)
        for start in range(0, 61, 16):
            q_index = torch.arange(start, min(start + 16, 61))
            sims = tretrieval._similarities(db[q_index], db, normalize)
            want = tretrieval._ranked(sims, q_index, topk=20)
            assert torch.equal(rank(db[q_index], q_index), want)


def _cli_setup(tmp_path):
    """test_cli_db_sharded.py's taxonomy and feature dump."""
    lines = []
    for mid, leaves in ((8, (0, 1)), (9, (2, 3)), (10, (4, 5)), (11, (6, 7))):
        lines += [f"12 {mid}"] + [f"{mid} {leaf}" for leaf in leaves]
    hier = tmp_path / "hier.txt"
    hier.write_text("\n".join(lines))
    from semantic_embeddings_tpu.data import get_data_generator

    ds = get_data_generator("synthetic-8")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16))
    feats = centers[np.asarray(ds.labels_test)] + 0.3 * rng.normal(size=(ds.num_test, 16))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    feat_path = tmp_path / "feat.pickle"
    with open(feat_path, "wb") as f:
        pickle.dump({"feat": {i: feats[i] for i in range(len(feats))}}, f)
    return ["--dataset", "synthetic-8", "--data_root", "x", "--hierarchy", str(hier),
            "--feat", str(feat_path), "--norm", "1", "--plot_max", "10", "--no_ap",
            "--clip_ahp", "20"]


def test_db_sharded_cli_matches_replicated_and_jax(tmp_path):
    """``evaluate_retrieval --gpus 3 --db_sharded`` (3 CPU devices, so that
    the rows are padded) against ``--gpus 3`` (replicated database, query
    blocks split), one device, and the JAX CLI's ``--gpus 8 --db_sharded``."""
    from semantic_embeddings_tpu.cli import evaluate_retrieval as jcli

    argv = _cli_setup(tmp_path)
    ref = next(iter(jcli.main(argv + ["--gpus", "8", "--db_sharded"]).values()))
    runs = [next(iter(tretrieval_cli.main(argv + ["--device", "cpu"] + extra).values()))
            for extra in (["--gpus", "3", "--db_sharded"], ["--gpus", "3"], [])]
    for got in runs:
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert runs[0] == runs[1]
    assert 0.0 < ref["P@1 (LCS_HEIGHT)"] <= 1.0


def test_db_sharded_refusals_match_jax():
    """The full-sort protocol and a missing device list are refused with the
    JAX package's messages."""
    from semantic_embeddings_tpu.hierarchy import ClassHierarchy as JHierarchy

    from semantic_embeddings_torch.hierarchy import ClassHierarchy

    feats, labels = np.eye(8, dtype=np.float32), ["a", "b"] * 4
    for kwargs in (dict(compute_ap=True), dict(compute_ap=False, compute_ahp=4, ks=[1])):
        with pytest.raises(ValueError) as ref:
            jretrieval.evaluate_retrieval_features(
                feats, labels, JHierarchy({"a": ["r"], "b": ["r"]}, {"r": ["a", "b"]}),
                db_sharded=True, mesh=get_mesh(8) if kwargs["compute_ap"] else None,
                **kwargs)
        with pytest.raises(ValueError) as ours:
            tretrieval.evaluate_retrieval_features(
                feats, labels, ClassHierarchy({"a": ["r"], "b": ["r"]}, {"r": ["a", "b"]}),
                db_sharded=True, devices=[CPU] * 2 if kwargs["compute_ap"] else None,
                **kwargs)
        assert str(ours.value) == str(ref.value)


# -- serving over device replicas ---------------------------------------------


def test_engine_over_two_devices_matches_one():
    """The engine over ['cpu', 'cpu']: buckets that are multiples of 2, and
    every request's rows as the one-device engine gives them."""
    torch.manual_seed(0)
    layer = torch.nn.Linear(6, 3)

    def fn(batch):
        with torch.no_grad():
            out = layer(torch.from_numpy(batch))
        return {"y": out, "sum": out.sum(1)}

    two = BatchingEngine([fn, fn], (6,), max_batch=8, timeout_ms=1.0)
    one = BatchingEngine(fn, (6,), max_batch=8, timeout_ms=1.0)
    assert two.buckets == [2, 4, 8] and one.buckets == [1, 2, 4, 8]
    with pytest.raises(ValueError, match="multiple of the 2 device replicas"):
        BatchingEngine([fn, fn], (6,), max_batch=7)
    rng = np.random.default_rng(0)
    with one, two:
        for n in (1, 3, 8):
            x = rng.normal(size=(n, 6)).astype(np.float32)
            a, b = one.predict(x, timeout=30), two.predict(x, timeout=30)
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6)
    assert two.stats()["padded_images"] >= 1
