"""The port's spatial partitioning (``--spatial``) against the JAX package's.

The JAX package's contract (``tests/test_spatial.py``): a step sharded over a
``(data, spatial)`` mesh is numerically the single-device step.  Here four
gloo ranks on the CPU (``parallel.launch``, started once for the module;
``tests/_torch_spatial_common.py``) run every case on a ``(2, 2)`` or a
``(1, 4)`` grid, each rank a block of every image's rows, and the JAX side
runs the single-device step in this process.

Tolerances, as stated in each test:

- against JAX's single-device step, the JAX test's own: the loss within
  rtol 1e-5, parameters and batch statistics within atol 2e-4 (1e-3 after
  ``fit``'s four steps, the loss within rtol 1e-2 for bf16 + remat).  A
  wrong halo or a missed collective shows at O(1e-2) (the JAX test's
  measure);
- the port's own cases against the port's one-process run, the data-parallel
  tests' rtol 1e-4 / atol 1e-5, in float64 where a whole train step is compared: in
  f32 a step of these small nets moves parameters by up to 5e-4 between
  two summation orders (the one-process f32 step is that far from its own
  f64 step), while in f64 the grid and the one process agree to ~1e-14, so
  a halo off by a row or a gradient off by a factor of S stands out.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_spatial_common as ranks
from semantic_embeddings_tpu.data import augment as jaugment
from semantic_embeddings_tpu.data import SyntheticDataset as JSyntheticDataset
from semantic_embeddings_tpu.models import EmbeddingModel as JEmbeddingModel
from semantic_embeddings_tpu.models import build_network as jbuild_network
from semantic_embeddings_tpu.parallel import get_mesh, shard_batch as jshard_batch
from semantic_embeddings_tpu.train import (
    make_eval_step as jmake_eval_step,
    make_train_step as jmake_train_step,
    new_train_state as jnew_train_state,
)
from semantic_embeddings_tpu.train.trainer import (
    make_classifier_eval_step as jclassifier_eval_step,
    make_classifier_train_step as jclassifier_step,
)
from semantic_embeddings_torch import convert, parallel

JAX_STEP = dict(rtol=0, atol=2e-4)
JAX_FIT = dict(rtol=0, atol=1e-3)
TOL = dict(rtol=1e-4, atol=1e-5)
EMB = np.eye(ranks.CLASSES, dtype=np.float32)


# -- the grid: shape, refusals, messages, row placement -----------------------


def test_grid_shape_and_refusal_match_jax_mesh():
    """``(N / S, S)`` in row-major order, as ``get_mesh(8, spatial=4)``;
    a spatial factor that does not divide the devices is refused."""
    mesh = get_mesh(8, spatial=4)
    devices = list(np.asarray(mesh.devices).reshape(-1))
    for rank in range(8):
        grid = parallel.Grid(4, 8, rank, groups=False)
        assert grid.shape == (dict(mesh.shape)["data"], dict(mesh.shape)["spatial"])
        d, s = np.argwhere(np.asarray(mesh.devices) == devices[rank])[0]
        assert (grid.data_index, grid.column) == (d, s)
    assert parallel.spatial_size(parallel.Grid(1, 8, 0, groups=False)) == 1
    assert parallel.spatial_size(None) == 1
    with pytest.raises(ValueError, match="multiple of spatial"):
        parallel.Grid(3, 8, 0, groups=False)
    with pytest.raises(ValueError, match="multiple of spatial"):
        get_mesh(8, spatial=3)


def test_image_rows_match_jax_placement():
    """Which images and which of their rows each rank holds: the JAX
    package's ``shard_batch`` on a (2, 4) mesh places an NHWC batch with
    ``(data, spatial)`` sharding (H divides), and each device's index is the
    port's ``image_sharding`` of that rank; the in-step ``constrain_spatial``
    cuts the same rows."""
    mesh = get_mesh(8, spatial=4)
    batch = np.arange(16 * 16 * 2 * 1, dtype=np.float32).reshape(16, 16, 2, 1)
    placed = jshard_batch(mesh, {"img": batch})["img"]
    where = placed.sharding.devices_indices_map(batch.shape)
    devices = list(np.asarray(mesh.devices).reshape(-1))
    for rank, device in enumerate(devices):
        grid = parallel.Grid(4, 8, rank, groups=False)
        (start, stop), (a, b) = parallel.image_sharding(grid, 16, 16)
        index = where[device]
        assert (index[0].start, index[0].stop, index[1].start, index[1].stop) == (
            start, stop, a, b)
        parallel.set_grid(grid)
        try:
            local = parallel.constrain_spatial(torch.from_numpy(batch[start:stop]))
        finally:
            parallel.set_grid(None)
        np.testing.assert_array_equal(local.numpy(), batch[start:stop, a:b])


# -- the cases, run once by four gloo ranks -----------------------------------


def _jax_simple(kind="embedding"):
    spec = jbuild_network(ranks.CLASSES, "simple", classification=kind == "classifier")
    model = spec.module if kind == "classifier" else JEmbeddingModel(
        backbone=spec.module, output="l2norm")
    variables = jax.device_get(jax.jit(
        lambda k: model.init(k, jnp.zeros((2, 16, 16, 3)), train=False))(
            jax.random.PRNGKey(0)))
    return spec, model, variables


def _port_state(case, variables):
    model, _ = ranks.model_of(case)
    convert.load_flax_variables(model, variables)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _aug_batch(rng, idx):
    n = len(idx)
    return {"idx": idx,
            "ty": rng.uniform(-1.6, 1.6, n).astype(np.float32),
            "tx": rng.uniform(-1.6, 1.6, n).astype(np.float32),
            "zy": rng.uniform(0.9, 1.1, n).astype(np.float32),
            "zx": rng.uniform(0.9, 1.1, n).astype(np.float32),
            "flip": rng.random(n) < 0.5}


def _cases():
    """``{name: case}``: the JAX spatial test's cases (with their JAX sides
    in ``jax_sides``) and the port's own."""
    jds = JSyntheticDataset(num_classes=ranks.CLASSES, n_train=64, n_test=32, size=16)
    raw32 = next(iter(jds.train_batches(32, 0, 0)))
    raw16 = next(iter(jds.train_batches(16, 0, 0)))
    rng = np.random.default_rng(7)
    cases, jax_sides = {}, {}

    spec, jmodel, variables = _jax_simple()
    base = {"arch": "simple"}
    base["state"] = _port_state(base, variables)
    for name, spatial in (("step_2x2", 2), ("step_1x4", 4)):
        cases[name] = dict(base, runner="step", spatial=spatial, batch=raw32)
    jax_sides["step"] = (spec, jmodel, variables, jds)
    cases["eval_1x4"] = dict(base, runner="eval", spatial=4, batch_size=32)
    aug = _aug_batch(rng, np.asarray(raw16["idx"]))
    cases["augment_2x2"] = dict(base, runner="step", spatial=2, batch=aug, clipnorm=10.0)
    jax_sides["augment"] = aug
    cases["fit_1x4"] = dict(base, runner="fit", spatial=4, epochs=2)

    cspec, cmodel, cvars = _jax_simple("classifier")
    cls = {"arch": "simple", "kind": "classifier"}
    cls["state"] = _port_state(cls, cvars)
    cases["classifier_2x2"] = dict(cls, runner="step", spatial=2, batch=raw16)
    cases["classifier_eval_2x2"] = dict(cls, runner="eval", spatial=2, batch_size=16)
    jax_sides["classifier"] = (cspec, cmodel, cvars)

    # --bf16 --remat: the JAX test's resnet-110-fc cut to one block a stage
    rspec = jbuild_network(ranks.CLASSES, "resnet-110-fc", dtype=jnp.bfloat16, remat=True)
    rspec.module = rspec.module.clone(n=1)
    rmodel = JEmbeddingModel(backbone=rspec.module, output="l2norm", dtype=jnp.bfloat16)
    rvars = jax.device_get(jax.jit(
        lambda k: rmodel.init(k, jnp.zeros((2, 16, 16, 3)), train=False))(
            jax.random.PRNGKey(0)))
    remat = {"arch": "resnet-110-fc-n1", "remat": True}
    remat["state"] = _port_state(remat, rvars)
    cases["bf16_remat_1x4"] = dict(remat, runner="step", spatial=4, batch=raw16, bf16=True)
    jax_sides["bf16_remat"] = (rspec, rmodel, rvars)

    # the port's own, in f64 against its one-process run
    f64 = torch.float64
    cases["rn18_1x4"] = dict(arch="rn18", runner="step", spatial=4, size=32, dtype=f64,
                             batch={"idx": np.arange(8, dtype=np.int32)})
    cases["rn18_remat_2x2"] = dict(arch="rn18", runner="step", spatial=2, size=32,
                                   dtype=f64, remat=True,
                                   batch={"idx": np.arange(8, 16, dtype=np.int32)})
    cases["nasnet_1x4"] = dict(arch="nasnet-tiny", runner="step", spatial=4, size=32,
                               dtype=f64, batch={"idx": np.arange(4, dtype=np.int32)})
    x = rng.normal(size=(4, 16, 16, 3))
    r = rng.normal(size=(4, 16, 16, ranks.CLASSES))
    for name, spatial, up in (("fcn_deconv_1x4", 4, "deconv"),
                              ("fcn_subpixel_2x2", 2, "subpixel"),
                              ("fcn_upsampling_1x4", 4, "upsampling")):
        cases[name] = dict(arch="fcn-tiny", kind="fcn", runner="fcn", spatial=spatial,
                           upsampling=up, dtype=f64, x=x, r=r)
    cases["per_replica_2x2"] = dict(arch="simple", runner="step", spatial=2, dtype=f64,
                                    bn_groups=2, batch=raw32)
    cases["grads_1x4"] = dict(arch="simple", runner="step", spatial=4, dtype=f64,
                              clipnorm=1e30, grads=True, batch=raw32)
    cases["grads_2x2"] = dict(cases["grads_1x4"], spatial=2)
    cases["features_1x4"] = dict(base, runner="features", spatial=4)
    # a 5-row map at (1, 4): blocks of 2, 2, 1 and none; a tie for the max
    xp = rng.normal(size=(2, 3, 5, 4))
    xp[0, 1, 0, 0] = xp[0, 1, 4, 3] = xp[0, 1].max() + 1.0
    cases["pools_1x4"] = dict(runner="pools", spatial=4, x=xp,
                              r=[rng.normal(size=(2, 3)), rng.normal(size=(2, 3)),
                                 rng.normal(size=(2, 60))])
    return cases, jax_sides


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Every case run once by four gloo ranks: ``(results, cases, JAX
    sides)``."""
    cases, jax_sides = _cases()
    tmp = tmp_path_factory.mktemp("spatial")
    with open(tmp / "cases.pickle", "wb") as f:
        pickle.dump(cases, f)
    parallel.launch(ranks.run, 4, str(tmp / "cases.pickle"), str(tmp / "out.pickle"))
    with open(tmp / "out.pickle", "rb") as f:
        return pickle.load(f), cases, jax_sides


def _flax(case, state):
    model, _ = ranks.model_of(dict(case, state=state))
    return convert.state_dict_to_flax(model)


def _assert_tree(got, want, tol, what):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(np.asarray(node, np.float64), np.asarray(leaf, np.float64),
                                   **tol, err_msg=f"{what} {path}")


def _jax_step(model, variables, prepare, raw, rng, **kwargs):
    step = jmake_train_step(model, prepare, **kwargs)
    return step(jnew_train_state(variables), raw, 0.1, rng)


@pytest.mark.parametrize("name", ["step_2x2", "step_1x4"])
def test_spatial_step_matches_jax_single_device(grid_runs, name):
    """``simple`` at 16 px, batch 32: the (2, 2) and (1, 4) grid steps (the
    latter's last maps of 2 and 1 rows leave two and three columns empty)
    against JAX's single-device step."""
    results, cases, jax_sides = grid_runs
    spec, model, variables, jds = jax_sides["step"]
    state, m = _jax_step(model, variables, jds.make_prepare(augment_train=False),
                         next(iter(jds.train_batches(32, 0, 0))), jax.random.PRNGKey(3),
                         loss_name="inv_corr", class_embedding=EMB,
                         l2_penalty_fn=spec.l2_penalty, clipnorm=10.0)
    got = results[name]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    tree = _flax(cases[name], got["state"])
    _assert_tree(tree["params"], state.params, JAX_STEP, "params")
    _assert_tree(tree["batch_stats"], state.batch_stats, JAX_STEP, "batch_stats")


def test_spatial_eval_step_matches_jax(grid_runs):
    """The eval step on a (1, 4) grid: the batch's count and summed loss
    against JAX's unsharded eval step."""
    results, _, jax_sides = grid_runs
    _, model, variables, jds = jax_sides["step"]
    ev = jmake_eval_step(model, jds.make_prepare(), loss_name="inv_corr",
                         class_embedding=EMB)
    m = ev(jnew_train_state(variables), next(iter(jds.test_batches(32))),
           jax.random.PRNGKey(0))
    got = results["eval_1x4"]
    assert got["count"] == 32.0 == float(m["count"])
    np.testing.assert_allclose(got["emb_loss"], float(m["emb_loss"]), rtol=1e-5)


def test_spatial_step_with_augmentation_matches_jax(grid_runs):
    """A (2, 2) step whose images are augmented (affine resampling of the
    whole image on every rank of a shard, then its rows cut) from the same
    drawn parameters as JAX's step."""
    results, _, jax_sides = grid_runs
    spec, model, variables, jds = jax_sides["step"]
    aug = jax_sides["augment"]
    xtr, ytr = jnp.asarray(jds._x_train_host), jnp.asarray(jds.labels_train)

    def prepare(raw, key, train):
        imgs = jax.vmap(jaugment._affine_sample)(
            xtr[raw["idx"]].astype(jnp.float32), raw["ty"], raw["tx"], raw["zy"],
            raw["zx"], raw["flip"])
        return (imgs - jds.mean) / jds.std, ytr[raw["idx"]]

    _, m = _jax_step(model, variables, prepare, aug, jax.random.PRNGKey(7),
                     loss_name="inv_corr", class_embedding=EMB,
                     l2_penalty_fn=spec.l2_penalty, clipnorm=10.0)
    np.testing.assert_allclose(results["augment_2x2"]["loss"], float(m["loss"]), rtol=1e-5)


def test_spatial_fit_matches_jax_single_device(grid_runs):
    """``fit`` for 2 epochs (4 steps) on a (1, 4) grid against JAX's
    single-device ``fit``: parameters within 1e-3 (the JAX test's bound for
    four compounded steps), the logged metrics within 3e-4."""
    from semantic_embeddings_tpu.train.schedules import PiecewiseSchedule as JSchedule
    from semantic_embeddings_tpu.train.trainer import fit as jfit

    results, cases, jax_sides = grid_runs
    spec, model, variables, jds = jax_sides["step"]
    prepare = jds.make_prepare(augment_train=False)
    kwargs = dict(loss_name="inv_corr", class_embedding=EMB)
    logged = []
    state = jfit(jnew_train_state(variables),
                 jmake_train_step(model, prepare, l2_penalty_fn=spec.l2_penalty,
                                  clipnorm=10.0, **kwargs),
                 jmake_eval_step(model, prepare, **kwargs), jds, JSchedule([(0, 0.1)]),
                 epochs=2, batch_size=32, verbose=False,
                 log_fn=lambda e, m: logged.append(m))
    got = results["fit_1x4"]
    tree = _flax(cases["fit_1x4"], got["state"])
    _assert_tree(tree["params"], state.params, JAX_FIT, "params")
    assert len(got["logged"]) == len(logged) == 2
    for ours, ref in zip(got["logged"], logged):
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], abs=3e-4), k


def test_classifier_step_spatial_matches_jax(grid_runs):
    """``learn_classifier``'s steps on a (2, 2) grid: the train step's loss
    and its eval step's count against JAX's single-device steps."""
    results, _, jax_sides = grid_runs
    spec, model, variables = jax_sides["classifier"]
    jds = jax_sides["step"][3]
    prepare = jds.make_prepare(augment_train=False)
    step = jclassifier_step(model, prepare, num_classes=ranks.CLASSES,
                            l2_penalty_fn=spec.l2_penalty)
    _, m = step(jnew_train_state(variables), next(iter(jds.train_batches(16, 0, 0))), 0.1,
                jax.random.PRNGKey(1))
    np.testing.assert_allclose(results["classifier_2x2"]["loss"], float(m["loss"]),
                               rtol=1e-5)
    ev = jclassifier_eval_step(model, prepare, num_classes=ranks.CLASSES)
    me = ev(jnew_train_state(variables), next(iter(jds.test_batches(16))),
            jax.random.PRNGKey(1))
    assert results["classifier_eval_2x2"]["count"] == 16.0 == float(me["count"])
    np.testing.assert_allclose(results["classifier_eval_2x2"]["emb_loss"],
                               float(me["emb_loss"]), rtol=1e-5)


def test_spatial_bf16_remat_step_matches_jax(grid_runs):
    """``--bf16 --remat --spatial``: one step of the rematerialized bf16
    resnet (one block a stage) on a (1, 4) grid: a finite loss within
    rtol 1e-2 of JAX's single-device bf16 step (the JAX test's bound)."""
    results, _, jax_sides = grid_runs
    spec, model, variables = jax_sides["bf16_remat"]
    jds = jax_sides["step"][3]
    _, m = _jax_step(model, variables, jds.make_prepare(augment_train=False),
                     next(iter(jds.train_batches(16, 0, 0))), jax.random.PRNGKey(5),
                     loss_name="inv_corr", class_embedding=EMB,
                     l2_penalty_fn=spec.l2_penalty, clipnorm=10.0)
    loss = results["bf16_remat_1x4"]["loss"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-2)


# -- the port's own cases, against its one-process run --------------------------


@pytest.mark.parametrize("name", ["rn18_1x4", "rn18_remat_2x2", "nasnet_1x4",
                                  "per_replica_2x2"])
def test_spatial_step_matches_one_process(grid_runs, name):
    """f64 steps against the one-process step: rn18 at 32 px (the stem's
    pad + VALID 7x7/2 conv, the max pool's pad, every ``conv_b`` through
    the fused op's plain halo path; its maps of 2 and 1 rows at (1, 4)),
    with ``--remat`` at (2, 2); a NASNet-A of one normal cell a stage (the
    factorized reduce's shift, SAME pools counted over the whole map, odd
    15- and 17-row maps); ``simple`` under ``--bn_per_replica`` (one
    BatchNorm group a data shard, its statistics across the shard's
    columns)."""
    results, cases, _ = grid_runs
    want = ranks.run_case(cases[name])
    got = results[name]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["fcn_deconv_1x4", "fcn_subpixel_2x2",
                                  "fcn_upsampling_1x4"])
def test_densenet_fcn_rows_match_one_process(grid_runs, name):
    """The DenseNet FCN (two dense blocks, 16 px) in training mode, f64:
    its whole output map, the gradients of sum(out * r) and the running
    statistics against the one-process run, with each of its upsamplings
    (the transposed conv, sub-pixel, nearest) and the crop to the skip."""
    results, cases, _ = grid_runs
    want = ranks.run_case(cases[name])
    got = results[name]
    np.testing.assert_allclose(got["out"], want["out"], **TOL)
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, **TOL, err_msg=k)
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["grads_1x4", "grads_2x2"])
def test_gradients_are_the_global_batch_mean(grid_runs, name):
    """The gradient rule: every parameter's gradient (no clip), summed over
    the ranks and divided by the data shards, equals the one-process
    gradient: the head's (computed by every column of a shard) and the
    backbone's (each row's on the rank that holds it).  Were the loss not
    scaled by 1 / S, or the sum divided by the world, the head's gradients
    would be S times too large or small."""
    results, cases, _ = grid_runs
    want = ranks.run_case(cases[name])["grads"]
    got = results[name]["grads"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-12 * np.abs(v).max(),
                                   err_msg=k)
    assert np.abs(want["backbone.top.weight"]).max() > 0


def test_whole_map_reductions_match_one_process(grid_runs):
    """``global_max_pool`` (a tie across two columns shares the gradient),
    ``global_avg_pool`` and ``flatten_nhwc`` of a 5-row map on a (1, 4)
    grid, an empty block among them, f64: the same outputs on every column
    as one process gives, and the map's gradient."""
    results, cases, _ = grid_runs
    want = ranks.run_case(cases["pools_1x4"])
    got = results["pools_1x4"]
    for g, w in zip(got["outs"], want["outs"]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got["grad"], want["grad"], **TOL)


def test_feature_dump_matches_one_process(grid_runs):
    """``extract_test_features`` (the feature dump) on a (1, 4) grid: every
    test image's embedding once, in order, as one process gives them."""
    results, cases, _ = grid_runs
    want = ranks.run_case(cases["features_1x4"])["features"]
    got = results["features_1x4"]["features"]
    assert got.shape == want.shape == (32, ranks.CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


# -- the halo op ---------------------------------------------------------------


def test_halo_op_gradcheck_and_opcheck():
    """The conv + statistics op with halo rows, in f64: its gradients
    (x, w and both halos; one halo alone) by ``gradcheck``, its schemas by
    ``opcheck``, and its y against the conv of the image with the halo rows
    on."""
    from torch.library import opcheck

    from semantic_embeddings_torch.ops import conv3x3 as C

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)

    x, w, top, bottom = rand(2, 3, 4, 5), rand(4, 3, 3, 3), rand(2, 3, 1, 5), rand(2, 3, 1, 5)
    y, s, ss = C.conv3x3_bn_stats(x, w, top, bottom)
    full = torch.nn.functional.conv2d(torch.cat([top, x, bottom], 2), w, padding=1)
    torch.testing.assert_close(y, full[:, :, 1:-1], rtol=0, atol=1e-12)
    torch.testing.assert_close(s, y.sum((0, 2, 3)), rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(C.conv3x3_bn_stats, (x, w, top, bottom))
    assert torch.autograd.gradcheck(lambda x, w, t: C.conv3x3_bn_stats(x, w, t, None),
                                     (x, w, top))
    assert torch.autograd.gradcheck(lambda x, w, b: C.conv3x3_bn_stats(x, w, None, b),
                                     (x, w, bottom))
    opcheck(C.conv3x3_bn_stats_op, (x, w, top, bottom))
    opcheck(C.conv3x3_bn_stats_op, (x, w, None, bottom))
    dy = torch.randn(2, 4, 4, 5, generator=g, dtype=torch.float64)
    opcheck(C.conv3x3_filter_grad, (x.detach(), dy, top.detach(), None))
    want = torch.nn.grad.conv2d_weight(torch.cat([top, x, bottom], 2).detach(), w.shape,
                                       torch.nn.functional.pad(dy, (0, 0, 1, 1)), padding=1)
    torch.testing.assert_close(C.conv3x3_filter_grad(x.detach(), dy, top.detach(),
                                                     bottom.detach()),
                               want, rtol=1e-12, atol=1e-12)
