"""The baseline learners' pieces against the JAX package's, on the same
numpy inputs and the same weights: the losses (DeViSE ranking, label
smoothing, the label-embedding loss, the center loss, cross-entropy on
logits), Keras Adagrad, the learner models (``LabelEmbedModel``,
``CenterLossModel``) and ``convert`` for them, the special train and eval
steps, the classifier step, and ``trainable_fn`` (the fine-tuning warm-up).

Tolerances, as tests/test_torch_train.py states them: one step of an
update (or one forward from the same weights) differs from the JAX one by
f32 sums taken in another order, a few ulp: rtol 1e-6 on the losses and
updates; three steps through a small network compound that to ~1e-5
relative: rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_embeddings_tpu.models import ModelSpec as JModelSpec
from semantic_embeddings_tpu.models.cifar_resnet import SmallResNet as JSmallResNet
from semantic_embeddings_tpu.models.heads import EmbeddingModel as JEmbeddingModel
from semantic_embeddings_tpu.models.learners import CenterLossModel as JCenterLossModel
from semantic_embeddings_tpu.models.learners import LabelEmbedModel as JLabelEmbedModel
from semantic_embeddings_tpu.train import losses as jL
from semantic_embeddings_tpu.train import make_classifier_eval_step as jclassifier_eval
from semantic_embeddings_tpu.train import make_classifier_train_step as jclassifier_step
from semantic_embeddings_tpu.train import make_train_step as jmake_train_step
from semantic_embeddings_tpu.train import new_train_state as jnew_train_state
from semantic_embeddings_tpu.train import optimizer as jO
from semantic_embeddings_tpu.train import run_validation as jrun_validation
from semantic_embeddings_tpu.train import special as jspecial
from semantic_embeddings_torch import convert
from semantic_embeddings_torch.models import (
    CenterLossModel,
    EmbeddingModel,
    LabelEmbedModel,
    ModelSpec,
)
from semantic_embeddings_torch.models.cifar_resnet import SmallResNet
from semantic_embeddings_torch.train import losses as L
from semantic_embeddings_torch.train import (
    make_classifier_eval_step,
    make_classifier_train_step,
    make_train_step,
    new_train_state,
    run_validation,
    special,
    trainable_indices,
)
from semantic_embeddings_torch.train import optimizer as O

ONE = dict(rtol=1e-6, atol=1e-6)
THREE = dict(rtol=1e-4, atol=1e-5)
N_CLS, DIM, SIZE, BATCH = 6, 8, 8, 12
FILTERS = [(r".*", 2e-4)]


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# -- losses ------------------------------------------------------------------


def test_devise_ranking_loss_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    emb = _unit_rows(rng, N_CLS, DIM)
    labels = rng.integers(0, N_CLS, 20)
    pred = rng.normal(size=(20, DIM)).astype(np.float32) * 0.3
    tp = _t(pred).requires_grad_()
    ours = L.devise_ranking_loss(emb, margin=0.2)(_t(emb[labels]), tp)
    ours.sum().backward()
    jloss = jL.devise_ranking_loss(emb, margin=0.2)
    ref = jloss(_j(emb[labels]), _j(pred))
    ref_g = jax.grad(lambda p: jloss(_j(emb[labels]), p).sum())(_j(pred))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **ONE)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_g), **ONE)
    assert (ours.detach().numpy() > 0).any()  # some hinges bind


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 1.0])
def test_label_smoothing_matches_jax(smoothing):
    onehot = np.eye(N_CLS, dtype=np.float32)[[0, 3, 5, 5]]
    np.testing.assert_allclose(L.label_smoothing(_t(onehot), smoothing).numpy(),
                               np.asarray(jL.label_smoothing(_j(onehot), smoothing)),
                               **ONE)


def test_softmax_crossentropy_logits_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(9, N_CLS)).astype(np.float32) * 4
    onehot = np.eye(N_CLS, dtype=np.float32)[rng.integers(0, N_CLS, 9)]
    np.testing.assert_allclose(
        L.softmax_crossentropy_logits(_t(onehot), _t(logits)).numpy(),
        np.asarray(jL.softmax_crossentropy_logits(_j(onehot), _j(logits))), **ONE)


@pytest.mark.parametrize("valid", [False, True])
def test_labelembed_loss_and_gradients_match_jax(valid):
    """The composite loss and its gradients to both heads and the table
    rows (the stop-gradients included); ``valid`` masks padded rows."""
    rng = np.random.default_rng(2)
    out1, out2, tar = (rng.normal(size=(10, N_CLS)).astype(np.float32) * 2 for _ in range(3))
    labels = rng.integers(0, N_CLS, 10)
    out2[:4] = np.eye(N_CLS, dtype=np.float32)[labels[:4]] * 5  # some correct rows
    mask = (np.arange(10) < 7).astype(np.float32) if valid else None
    ins = [_t(a).requires_grad_() for a in (out1, out2, tar)]
    ours = L.labelembed_loss(*ins, _t(labels), tau=2.0, alpha=0.9, beta=0.5,
                             valid=None if mask is None else _t(mask))
    ours.sum().backward()

    def jloss(o1, o2, tr):
        return jL.labelembed_loss(o1, o2, tr, _j(labels), tau=2.0, alpha=0.9, beta=0.5,
                                  valid=None if mask is None else _j(mask))

    ref = jloss(_j(out1), _j(out2), _j(tar))
    grads = jax.grad(lambda *a: jloss(*a).sum(), argnums=(0, 1, 2))(
        _j(out1), _j(out2), _j(tar))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **ONE)
    for got, want in zip(ins, grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **ONE)


def test_center_loss_and_gradients_match_jax():
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(10, DIM)).astype(np.float32)
    cents = rng.normal(size=(N_CLS, DIM)).astype(np.float32)
    labels = rng.integers(0, N_CLS, 10)
    te, tcents = _t(emb).requires_grad_(), _t(cents).requires_grad_()
    ours = L.center_loss(te, tcents, _t(labels))
    ours.sum().backward()
    ref = jL.center_loss(_j(emb), _j(cents), _j(labels))
    ge, gc = jax.grad(lambda e, c: jL.center_loss(e, c, _j(labels)).sum(),
                      argnums=(0, 1))(_j(emb), _j(cents))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **ONE)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **ONE)
    np.testing.assert_allclose(tcents.grad.numpy(), np.asarray(gc), **ONE)


# -- Adagrad -----------------------------------------------------------------


@pytest.mark.parametrize("steps,tol", [(1, ONE), (3, THREE)])
def test_adagrad_update_matches_jax(steps, tol):
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp = {str(i): _j(p) for i, p in enumerate(params)}
    ja = jO.init_velocity(jp)
    tp = [_t(p.copy()) for p in params]
    ta = O.init_velocity(tp)
    for lr in [0.5, 0.1, 0.3][:steps]:
        g = [(rng.normal(size=s) * 2).astype(np.float32) for s in shapes]
        jp, ja = jO.adagrad_update(jp, ja, {str(i): _j(x) for i, x in enumerate(g)}, lr)
        O.adagrad_update(tp, ta, [_t(x) for x in g], lr)
    for i in range(len(shapes)):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[str(i)]), **tol)
        np.testing.assert_allclose(ta[i].numpy(), np.asarray(ja[str(i)]), **tol)


# -- the learner models ------------------------------------------------------


def _backbones(top_activation=None, classes=DIM):
    j = JSmallResNet(n=1, filters=(4, 8, 8), classes=classes, include_top=True,
                     top_activation=top_activation)
    t = SmallResNet(n=1, filters=(4, 8, 8), classes=classes, include_top=True,
                    top_activation=top_activation)
    return j, t


def _pair(kind, fixed=None):
    """(JAX model, its variables, the port's model from the same weights)."""
    jb, tb = _backbones()
    if kind == "labelembed":
        jm, tm = JLabelEmbedModel(backbone=jb, num_classes=N_CLS), LabelEmbedModel(tb, N_CLS)
    else:
        jm = JCenterLossModel(backbone=jb, num_classes=N_CLS, embed_dim=DIM,
                              fixed_centroids=fixed)
        tm = CenterLossModel(tb, N_CLS, DIM, fixed_centroids=fixed)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                       jnp.zeros((1,), jnp.int32), train=False))
    convert.load_flax_variables(tm, variables)
    return jm, variables, tm


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "y": rng.integers(0, N_CLS, BATCH).astype(np.int32)} for _ in range(n)]


def _jprepare(raw, rng, train):
    return raw["x"], raw["y"]


def _tprepare(raw, rng, train):
    return _t(raw["x"]), _t(raw["y"]).long()


@pytest.mark.parametrize("kind", ["labelembed", "center_loss"])
def test_learner_models_match_jax_and_convert_round_trips(kind):
    """Train-mode outputs (BN batch statistics, their running-statistics
    update) and eval-mode ones from the same weights; the label-free call
    gives (embedding, prob); state_dict_to_flax gives the JAX tree back."""
    jm, variables, tm = _pair(kind)
    raw = _batches(1)[0]
    jout, mut = jm.apply(variables, _j(raw["x"]), _j(raw["y"]), train=True,
                         mutable=["batch_stats"])
    tm.train()
    tout = tm(_t(raw["x"]), _t(raw["y"]).long())
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    back = convert.state_dict_to_flax(tm)
    flat = jax.tree_util.tree_flatten_with_path(mut["batch_stats"])[0]
    for path, leaf in flat:
        node = back["batch_stats"]
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-5, atol=1e-6)
    jeval = jm.apply(variables, _j(raw["x"]), _j(raw["y"]), train=False)
    tm.load_state_dict(convert.flax_to_state_dict(variables, tm))
    tm.eval()
    with torch.no_grad():
        teval = tm(_t(raw["x"]), _t(raw["y"]).long())
        emb, prob = tm(_t(raw["x"]))
    for a, b in zip(teval, jeval):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(emb.numpy(), teval[0].numpy())
    np.testing.assert_allclose(prob.numpy().sum(1), 1.0, rtol=1e-6)
    back = convert.state_dict_to_flax(tm)
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[coll])[0]:
            node = back[coll]
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))


def test_label_embedding_table_starts_as_identity_and_centroids_fixed():
    _, _, tm = _pair("labelembed")
    assert torch.equal(LabelEmbedModel(_backbones()[1], N_CLS).labelembeddings,
                       torch.eye(N_CLS))
    fixed = _unit_rows(np.random.default_rng(6), N_CLS, DIM)
    cm = CenterLossModel(_backbones()[1], N_CLS, DIM, fixed_centroids=fixed)
    np.testing.assert_array_equal(cm.cls_centroids.detach().numpy(), fixed)
    learned = CenterLossModel(_backbones()[1], N_CLS, DIM).cls_centroids
    assert learned.abs().max() <= 0.05 and learned.std() > 0.01  # Keras's U(-0.05, 0.05)
    with pytest.raises(ValueError, match="does not match"):
        CenterLossModel(_backbones()[1], N_CLS + 1, DIM, fixed_centroids=fixed)


# -- the special train and eval steps ----------------------------------------


def _assert_state(tmodel, jstate, tol):
    got = convert.state_dict_to_flax(tmodel)
    for coll, want in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = got[coll]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, np.asarray(leaf), **tol,
                                       err_msg=f"{coll}/{path}")


def _run_steps(jstep, tstep, jstate, tstate, n, tol, keys=("loss",)):
    for raw, lr in zip(_batches(n), [0.5, 0.2, 0.05]):
        jstate, jm = jstep(jstate, {k: _j(v) for k, v in raw.items()}, lr,
                           jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, raw, lr, None)
        for k in keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **tol, err_msg=k)
    return jstate, tstate


@pytest.mark.parametrize("steps,tol", [(1, ONE), (3, THREE)])
def test_labelembed_steps_match_jax(steps, tol):
    jm, variables, tm = _pair("labelembed")
    jb, tb = jm.backbone, tm.backbone
    jl2 = lambda p: JModelSpec("x", jb, FILTERS).l2_penalty(p["backbone"])  # noqa: E731
    tspec = ModelSpec("x", tb, FILTERS)
    jstep = jspecial.make_labelembed_train_step(jm, _jprepare, clipnorm=1.0,
                                                l2_penalty_fn=jl2)
    tstep = special.make_labelembed_train_step(
        tm, _tprepare, clipnorm=1.0, l2_penalty_fn=lambda m: tspec.l2_penalty(m.backbone))
    jstate, tstate = _run_steps(jstep, tstep, jnew_train_state(variables),
                                new_train_state(tm), steps, tol, ("loss", "acc"))
    _assert_state(tm, jstate, tol)
    # validation over padded batches (the loss's batch-coupled term on the
    # valid rows only)
    raw = dict(_batches(1, seed=9)[0], valid=(np.arange(BATCH) < 9).astype(np.float32))
    jeval = jspecial.make_labelembed_eval_step(jm, _jprepare, l2_penalty_fn=jl2)
    teval = special.make_labelembed_eval_step(
        tm, _tprepare, l2_penalty_fn=lambda m: tspec.l2_penalty(m.backbone))
    ref = jrun_validation(jeval, jstate, [{k: _j(v) for k, v in raw.items()}], None)
    ours = run_validation(teval, tstate, [raw], None)
    np.testing.assert_array_equal(ours.pop("predictions"), ref.pop("predictions"))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], **tol, err_msg=k)


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("steps,tol", [(1, ONE), (3, THREE)])
def test_center_loss_steps_match_jax(steps, tol, fixed):
    """Learned centroids, and fixed ones, which the step's trainable mask
    keeps bitwise as given."""
    cents = _unit_rows(np.random.default_rng(7), N_CLS, DIM) if fixed else None
    jm, variables, tm = _pair("center_loss", cents)
    trainable = (lambda p: "cls_centroids" not in p) if fixed else None
    jl2 = lambda p: JModelSpec("x", jm.backbone, FILTERS).l2_penalty(p["backbone"])  # noqa: E731
    tspec = ModelSpec("x", tm.backbone, FILTERS)
    kw = dict(num_classes=N_CLS, center_loss_weight=0.1, clipnorm=1.0,
              trainable_fn=trainable)
    jstep = jspecial.make_center_loss_train_step(jm, _jprepare, l2_penalty_fn=jl2, **kw)
    tstep = special.make_center_loss_train_step(
        tm, _tprepare, l2_penalty_fn=lambda m: tspec.l2_penalty(m.backbone), **kw)
    jstate, tstate = _run_steps(jstep, tstep, jnew_train_state(variables),
                                new_train_state(tm), steps, tol,
                                ("loss", "ce", "center_loss", "acc"))
    _assert_state(tm, jstate, tol)
    if fixed:
        np.testing.assert_array_equal(tm.cls_centroids.detach().numpy(), cents)
    raw = dict(_batches(1, seed=9)[0], valid=(np.arange(BATCH) < 9).astype(np.float32))
    jeval = jspecial.make_center_loss_eval_step(jm, _jprepare, num_classes=N_CLS,
                                                l2_penalty_fn=jl2)
    teval = special.make_center_loss_eval_step(
        tm, _tprepare, num_classes=N_CLS, l2_penalty_fn=lambda m: tspec.l2_penalty(m.backbone))
    ref = jrun_validation(jeval, jstate, [{k: _j(v) for k, v in raw.items()}], None)
    ours = run_validation(teval, tstate, [raw], None)
    np.testing.assert_array_equal(ours.pop("predictions"), ref.pop("predictions"))
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], **tol, err_msg=k)


# -- the classifier step, trainable_fn and Adagrad in the step --------------


def _frozen_unchanged(tmodel, before, trained_names):
    for name, value in tmodel.state_dict().items():
        if name in trained_names or "running" in name:
            continue
        assert torch.equal(value, before[name]), name


@pytest.mark.parametrize("top_only", [False, True])
def test_classifier_steps_match_jax(top_only):
    """Three classifier steps with label smoothing (and the fine-tuning
    warm-up's ``top``-only mask): the frozen parameters stay bitwise as
    they were, the BN running statistics move, and everything matches."""
    jb, tb = _backbones("softmax", classes=N_CLS)
    variables = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    convert.load_flax_variables(tb, variables)
    before = {k: v.clone() for k, v in tb.state_dict().items()}
    trainable = (lambda p: "top" in p) if top_only else None
    kw = dict(num_classes=N_CLS, label_smoothing=0.1, clipnorm=1.0, trainable_fn=trainable)
    jstep = jclassifier_step(jb, _jprepare, l2_penalty_fn=JModelSpec("x", jb, FILTERS)
                             .l2_penalty, **kw)
    tstep = make_classifier_train_step(tb, _tprepare, l2_penalty_fn=ModelSpec(
        "x", tb, FILTERS).l2_penalty, **kw)
    jstate, tstate = _run_steps(jstep, tstep, jnew_train_state(variables),
                                new_train_state(tb), 3, THREE, ("loss", "ce", "acc"))
    _assert_state(tb, jstate, THREE)
    if top_only:
        assert [n for n, _ in tb.named_parameters()][-2:] == ["top.weight", "top.bias"]
        _frozen_unchanged(tb, before, {"top.weight", "top.bias"})
        assert not torch.equal(tb.top.weight, before["top.weight"])
        assert not torch.equal(tb.bn0.running_mean, before["bn0.running_mean"])
    raw = dict(_batches(1, seed=9)[0], valid=(np.arange(BATCH) < 9).astype(np.float32))
    jeval = jclassifier_eval(jb, _jprepare, num_classes=N_CLS, label_smoothing=0.1)
    teval = make_classifier_eval_step(tb, _tprepare, num_classes=N_CLS, label_smoothing=0.1)
    ref = jrun_validation(jeval, jstate, [{k: _j(v) for k, v in raw.items()}], None)
    ours = run_validation(teval, tstate, [raw], None)
    np.testing.assert_array_equal(ours.pop("predictions"), ref.pop("predictions"))
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], **THREE, err_msg=k)


@pytest.mark.parametrize("optimizer,loss", [("sgd", "inv_corr"), ("adagrad", "devise")])
def test_masked_embedding_steps_match_jax(optimizer, loss):
    """The fine-tuning warm-ups of the embedding learners: the cosine loss
    with the head on SGD (``learn_image_embeddings --finetune``), and
    DeViSE's ranking loss on Adagrad (``learn_devise --init_weights``),
    each training only ``top``: three steps against the JAX step; the
    frozen tensors stay bitwise as they were."""
    rng = np.random.default_rng(8)
    emb = _unit_rows(rng, N_CLS, DIM)
    cls = N_CLS if loss == "inv_corr" else 0
    jb, tb = _backbones()
    output = "l2norm" if loss == "inv_corr" else "linear"
    jm = JEmbeddingModel(backbone=jb, output=output, cls_classes=cls)
    tm = EmbeddingModel(tb, output=output, cls_classes=cls)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    convert.load_flax_variables(tm, variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    kw = dict(class_embedding=emb, num_classes=N_CLS, cls_weight=0.1 if cls else 0.0,
              optimizer=optimizer, clipnorm=1.0 if optimizer == "sgd" else 0.0)
    jextra, textra = {}, {}
    if loss == "devise":
        jextra["loss_fn_override"] = jL.devise_ranking_loss(emb, 0.1)
        textra["loss_fn_override"] = L.devise_ranking_loss(emb, 0.1)
    jstep = jmake_train_step(jm, _jprepare, trainable_fn=lambda p: "top" in p,
                             l2_penalty_fn=JModelSpec("x", jb, FILTERS).l2_penalty,
                             **kw, **jextra)
    tstep = make_train_step(tm, _tprepare, trainable_fn=lambda p: "top" in p,
                            l2_penalty_fn=ModelSpec("x", tb, FILTERS).l2_penalty,
                            **kw, **textra)
    jstate, tstate = _run_steps(jstep, tstep, jnew_train_state(variables),
                                new_train_state(tm), 3, THREE, ("loss", "emb_loss"))
    _assert_state(tm, jstate, THREE)
    trained = {n for n, _ in tm.named_parameters() if "top" in n}
    assert trained >= {"backbone.top.weight"} and len(trained) == (4 if cls else 2)
    _frozen_unchanged(tm, before, trained)
    for n in trained:
        assert not torch.equal(tm.state_dict()[n], before[n]), n


def test_trainable_indices_follow_the_jax_paths():
    jb, tb = _backbones()
    tm = EmbeddingModel(tb, output="l2norm", cls_classes=N_CLS)
    names = [n for n, _ in tm.named_parameters()]
    picked = [names[i] for i in trainable_indices(tm, lambda p: "top" in p)]
    assert picked == ["backbone.top.weight", "backbone.top.bias", "cls_top.weight",
                      "cls_top.bias"]
    assert trainable_indices(tm) == list(range(len(names)))
    seen = []
    trainable_indices(tm, lambda p: seen.append(p) or False)
    assert "backbone/conv0/weight" in seen and "cls_bn/weight" in seen
