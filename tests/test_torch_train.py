"""The port's losses, metrics, optimizer, schedules and train step against
the JAX package's, on the same numpy inputs and the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.data import augment as jaugment
from semantic_embeddings_tpu.data.cifar import SyntheticDataset as JSyntheticDataset
from semantic_embeddings_tpu.models import ModelSpec as JModelSpec
from semantic_embeddings_tpu.models.cifar_resnet import SmallResNet as JSmallResNet
from semantic_embeddings_tpu.models.heads import EmbeddingModel as JEmbeddingModel
from semantic_embeddings_tpu.ops import fused_cosine_loss as jfused
from semantic_embeddings_tpu.ops import l2_normalize as jl2
from semantic_embeddings_tpu.train import losses as jL
from semantic_embeddings_tpu.train import make_eval_step as jmake_eval_step
from semantic_embeddings_tpu.train import make_train_step as jmake_train_step
from semantic_embeddings_tpu.train import metrics as jM
from semantic_embeddings_tpu.train import new_train_state as jnew_train_state
from semantic_embeddings_tpu.train import optimizer as jO
from semantic_embeddings_tpu.train import run_validation as jrun_validation
from semantic_embeddings_tpu.train import schedules as jS
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.data import augment
from semantic_embeddings_torch.models import ModelSpec
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.models.heads import EmbeddingModel
from semantic_embeddings_torch.ops import fused_cosine_loss, l2_normalize
from semantic_embeddings_torch.train import losses as L
from semantic_embeddings_torch.train import (
    make_eval_step,
    make_train_step,
    new_train_state,
    run_validation,
)
from semantic_embeddings_torch.train import metrics as M
from semantic_embeddings_torch.train import optimizer as O
from semantic_embeddings_torch.train import schedules as S


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["inv_correlation", "squared_distance"])
def test_embedding_losses_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _unit_rows(rng, 33, 20), rng.normal(size=(33, 20)).astype(np.float32)
    ours = getattr(L, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(getattr(jL, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_categorical_crossentropy_matches_jax():
    """Includes probabilities at 0 and 1, where the Keras clip binds."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(16, 7)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs[0] = np.eye(7)[2]
    probs[1] = np.eye(7)[3]
    onehot = np.eye(7, dtype=np.float32)[rng.integers(0, 7, 16)]
    onehot[0] = np.eye(7)[2]
    onehot[1] = np.eye(7)[4]
    ours = L.categorical_crossentropy(torch.from_numpy(onehot),
                                      torch.from_numpy(probs)).numpy()
    ref = np.asarray(jL.categorical_crossentropy(jnp.asarray(onehot),
                                                 jnp.asarray(probs)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dot,k", [(True, 1), (False, 1), (True, 3)])
def test_nn_accuracy_matches_jax(dot, k):
    rng = np.random.default_rng(2)
    emb = _unit_rows(rng, 10, 12)
    labels = rng.integers(0, 10, 64)
    pred = emb[labels] + rng.normal(size=(64, 12)).astype(np.float32) * 0.6
    ours = M.nn_accuracy(emb, dot_prod_sim=dot, k=k)(
        torch.from_numpy(emb[labels]), torch.from_numpy(pred)).numpy()
    ref = np.asarray(jM.nn_accuracy(emb, dot_prod_sim=dot, k=k)(
        jnp.asarray(emb[labels]), jnp.asarray(pred)))
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours.mean() < 1  # neither trivially right nor wrong


def test_balanced_accuracy_matches_jax():
    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 9, 200), rng.integers(0, 9, 200)
    assert M.balanced_accuracy(y_pred, y_true) == jM.balanced_accuracy(
        y_pred, y_true)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_update_matches_jax(nesterov):
    """Three Keras-SGD steps with a changing lr and a clipnorm that binds
    on some tensors and not on others."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * sc).astype(np.float32)
              for s, sc in zip(shapes, (5.0, 0.1, 2.0))] for _ in range(3)]
    lrs = [0.5, 0.1, 0.3]

    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jv = jO.init_velocity(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tv = O.init_velocity(tp)
    for g, lr in zip(grads, lrs):
        jp, jv = jO.sgd_update(jp, jv, {str(i): jnp.asarray(x) for i, x in enumerate(g)},
                               lr, momentum=0.9, nesterov=nesterov, clipnorm=1.0)
        O.sgd_update(tp, tv, [torch.from_numpy(x) for x in g], lr,
                     momentum=0.9, nesterov=nesterov, clipnorm=1.0)
    for i in range(len(shapes)):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[str(i)]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tv[i].numpy(), np.asarray(jv[str(i)]),
                                   rtol=1e-6, atol=1e-6)


def test_clip_by_per_tensor_norm_matches_jax():
    rng = np.random.default_rng(5)
    grads = [rng.normal(size=(6, 7)).astype(np.float32) * s for s in (3.0, 0.01)]
    ours = O.clip_by_per_tensor_norm([torch.from_numpy(g) for g in grads], 2.0)
    ref = jO.clip_by_per_tensor_norm([jnp.asarray(g) for g in grads], 2.0)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert abs(float(torch.linalg.vector_norm(ours[0])) - 2.0) < 1e-5


def test_decay_helpers_match_jax():
    assert O.decay_from_max_decay(0.01, 500, 30) == jO.decay_from_max_decay(
        0.01, 500, 30)
    assert O.effective_lr(0.5, 1e-3, 700) == jO.effective_lr(0.5, 1e-3, 700)
    assert O.effective_lr(0.5, 0.0, 700) == 0.5


@pytest.mark.parametrize("name,args", [
    ("SGDR", {"sgdr_max_lr": 0.5}),
    ("SGDR", {"sgdr_max_lr": 0.1, "sgdr_base_len": 3, "sgdr_mul": 3}),
    ("CLR", {"clr_step_len": 2}),
    ("SGD", {"sgd_schedule": "1:0.1,3:0.01,5:0.005,7:0.001,9"}),
    ("ResNet-Schedule", {}),
])
def test_schedules_match_jax(name, args):
    ours, n1 = S.get_lr_schedule(name, 1000, 100, args)
    ref, n2 = jS.get_lr_schedule(name, 1000, 100, args)
    assert n1 == n2
    trace = [(e, e * 10 + i) for e in range(0, 200, 3) for i in (0, 4)]
    assert [ours.lr(e, it) for e, it in trace] == [ref.lr(e, it) for e, it in trace]


def test_plateau_schedule_matches_jax():
    ours, _ = S.get_lr_schedule("SGD", 1000, 100, {"sgd_patience": 2})
    ref, _ = jS.get_lr_schedule("SGD", 1000, 100, {"sgd_patience": 2})
    for loss in [1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.9, 0.9, 0.9, 0.9]:
        ours.observe({"val_loss": loss})
        ref.observe({"val_loss": loss})
        assert ours.lr(0) == ref.lr(0)
    assert ours.lr(0) < 0.1


# -- three --fused_loss train steps against the JAX train step -----------


def test_fused_loss_train_steps_match_jax():
    """Three steps of the ``--fused_loss`` recipe (raw-embedding train
    model, cls head on l2norm(emb), cls_weight 0.1, L2 filters with the
    ``^cls_top$`` rule, Keras SGD with a binding clipnorm) on a small
    SmallResNet, from the same weights, batches and augmentation
    parameters.  Tolerance: f32 sums taken in another order compound over
    ~15 layers, backward and three updates, to ~1e-5 relative; rtol 1e-4."""
    n_cls, dim, size, batch = 10, 12, 16, 16
    ds = JSyntheticDataset(num_classes=n_cls, n_train=64, n_test=16, size=size)
    rng = np.random.default_rng(6)
    emb = _unit_rows(rng, n_cls, dim)
    filters = [(r"^cls_top$", 5e-4), (r".*", 2e-4)]
    lrs = [0.5, 0.2, 0.05]
    steps = []
    for _ in lrs:
        b = batch
        steps.append({
            "idx": rng.integers(0, 64, b).astype(np.int32),
            "ty": rng.uniform(-2.4, 2.4, b).astype(np.float32),
            "tx": rng.uniform(-2.4, 2.4, b).astype(np.float32),
            "zy": rng.uniform(0.9, 1.1, b).astype(np.float32),
            "zx": rng.uniform(0.9, 1.1, b).astype(np.float32),
            "flip": rng.random(b) < 0.5,
        })

    # JAX side
    jbackbone = JSmallResNet(n=2, filters=(8, 16, 32), classes=dim,
                             include_top=True, top_activation=None)
    jtrain = JEmbeddingModel(backbone=jbackbone, output="linear",
                             cls_classes=n_cls, cls_input="l2norm")
    variables = jtrain.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    jstate = jnew_train_state(variables)
    xtr = jnp.asarray(ds._x_train_host)
    ytr = jnp.asarray(ds.labels_train)
    mean, std = ds.mean, ds.std

    def jprepare(raw, key, train):
        imgs = jax.vmap(jaugment._affine_sample)(
            xtr[raw["idx"]].astype(jnp.float32), raw["ty"], raw["tx"],
            raw["zy"], raw["zx"], raw["flip"])
        return (imgs - mean) / std, ytr[raw["idx"]]

    jmetric = jM.nn_accuracy(emb, dot_prod_sim=True)
    jstep = jmake_train_step(
        jtrain, jprepare, loss_name="inv_corr", class_embedding=emb,
        num_classes=n_cls, cls_weight=0.1,
        l2_penalty_fn=JModelSpec("x", jbackbone, filters).l2_penalty,
        clipnorm=1.0, loss_fn_override=lambda tgt, z: jfused(z, tgt),
        metric_fn={"emb": lambda tgt, z: jmetric(tgt, jl2(z))})

    # PyTorch side, from the same weights
    tbackbone = SmallResNet(n=2, filters=(8, 16, 32), classes=dim,
                            include_top=True)
    tmodel = EmbeddingModel(tbackbone, output="l2norm", cls_classes=n_cls)
    convert.load_flax_variables(tmodel, variables)
    tstate = new_train_state(tmodel)
    txtr = torch.from_numpy(ds._x_train_host)
    tytr = torch.from_numpy(ds.labels_train.astype(np.int64))

    def tprepare(raw, rng, train):
        idx = torch.from_numpy(raw["idx"]).long()
        imgs = augment.affine_apply(
            txtr[idx].float(), *(torch.from_numpy(np.asarray(raw[k]))
                                 for k in ("ty", "tx", "zy", "zx", "flip")))
        return (imgs - torch.from_numpy(mean)) / torch.from_numpy(std), tytr[idx]

    tmetric = M.nn_accuracy(emb, dot_prod_sim=True)
    tstep = make_train_step(
        tmodel.twin("linear", cls_input="l2norm"), tprepare,
        loss_name="inv_corr", class_embedding=emb, num_classes=n_cls,
        cls_weight=0.1, l2_penalty_fn=ModelSpec("x", tbackbone, filters).l2_penalty,
        clipnorm=1.0, loss_fn_override=lambda tgt, z: fused_cosine_loss(z, tgt),
        metric_fn={"emb": lambda tgt, z: tmetric(tgt, l2_normalize(z))})

    for raw, lr in zip(steps, lrs):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in raw.items()},
                           lr, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, raw, lr, None)
        for k in ("loss", "emb_loss", "cls_loss", "cls_acc", "emb"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert tstate.step == 3
    got = convert.state_dict_to_flax(tmodel)
    for coll, want in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        for path, leaf in flat_w:
            node = got[coll]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{coll}/{path}")

    # Validation of the trained state with the l2norm-output model over
    # padded test batches (16 rows in batches of 6: 2 padded rows masked).
    jeval_model = JEmbeddingModel(backbone=jbackbone, output="l2norm",
                                  cls_classes=n_cls)
    xte, yte = jnp.asarray(ds._x_test_host), jnp.asarray(ds.labels_test)
    txte = torch.from_numpy(ds._x_test_host)
    tyte = torch.from_numpy(ds.labels_test.astype(np.int64))

    def jprepare_eval(raw, key, train):
        return (xte[raw["idx"]].astype(jnp.float32) - mean) / std, yte[raw["idx"]]

    def tprepare_eval(raw, rng, train):
        idx = torch.from_numpy(raw["idx"]).long()
        return (txte[idx].float() - torch.from_numpy(mean)) / torch.from_numpy(std), tyte[idx]

    jeval = jmake_eval_step(
        jeval_model, jprepare_eval, loss_name="inv_corr", class_embedding=emb,
        num_classes=n_cls, cls_weight=0.1,
        l2_penalty_fn=JModelSpec("x", jbackbone, filters).l2_penalty,
        metric_fn={"emb": jmetric})
    teval = make_eval_step(
        tmodel, tprepare_eval, loss_name="inv_corr", class_embedding=emb,
        num_classes=n_cls, cls_weight=0.1,
        l2_penalty_fn=ModelSpec("x", tbackbone, filters).l2_penalty,
        metric_fn={"emb": tmetric})
    ref = jrun_validation(jeval, jstate, (
        {k: jnp.asarray(v) for k, v in raw.items()} for raw in ds.test_batches(6)),
        jax.random.PRNGKey(0))
    ours = run_validation(teval, tstate, ds.test_batches(6), None)
    assert sorted(ours) == sorted(ref)
    np.testing.assert_array_equal(ours.pop("predictions"), ref.pop("predictions"))
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


# -- --profile_dir ---------------------------------------------------------------


def _profiled_fit(profile_dir, steps, epochs):
    """``fit`` of a tiny ``simple`` net (2 steps an epoch) with a profile
    window."""
    from semantic_embeddings_torch.data import SyntheticDataset
    from semantic_embeddings_torch.models import build_network
    from semantic_embeddings_torch.train import fit, make_eval_step, make_train_step
    from semantic_embeddings_torch.train import new_train_state

    data = SyntheticDataset(num_classes=4, n_train=16, n_test=8, size=8)
    g = torch.Generator().manual_seed(0)
    model = EmbeddingModel(build_network(4, "simple", generator=g).module, output="l2norm")
    prepare = data.make_prepare("cpu")
    emb = np.eye(4, dtype=np.float32)
    fit(new_train_state(model), make_train_step(model, prepare, class_embedding=emb),
        make_eval_step(model, prepare, class_embedding=emb), data,
        S.PiecewiseSchedule([(0, 0.1)]), epochs=epochs, batch_size=8, verbose=False,
        profile_dir=profile_dir, profile_steps=steps)


def test_profile_dir_writes_a_trace_of_the_window(tmp_path, capsys):
    """The JAX package's window, [start, stop) counted from this run's first
    step: with ``profile_steps=(1, 3)`` over 4 steps the trace closes before
    step 3 and is written (this rank's file), with JAX's message."""
    import json
    import os

    _profiled_fit(str(tmp_path / "trace"), (1, 3), 2)
    assert f"Wrote device trace to {tmp_path / 'trace'}" in capsys.readouterr().out
    assert os.listdir(tmp_path / "trace") == ["trace_rank0.json"]
    with open(tmp_path / "trace" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("conv2d" in e.get("name", "") for e in events)


def test_profile_dir_warns_when_the_run_ends_before_the_window(tmp_path, capsys):
    """A run shorter than the window's start writes nothing and warns with
    the JAX package's text; one that ends inside the window still writes
    its trace."""
    with pytest.warns(RuntimeWarning) as record:
        _profiled_fit(str(tmp_path / "early"), (10, 30), 1)
    assert str(record[0].message) == (
        "--profile_dir was set but the run finished after 2 steps, before the "
        "profile window start (step 10); no trace was written. Lower profile_steps "
        "or run more steps.")
    assert not (tmp_path / "early").exists()
    _profiled_fit(str(tmp_path / "inside"), (1, 30), 1)
    assert "Wrote device trace to" in capsys.readouterr().out
    assert (tmp_path / "inside" / "trace_rank0.json").exists()
