"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a GPU).

This file imports no JAX, so that a GPU machine without JAX runs it with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

(``tests/conftest.py`` configures JAX, hence ``--noconftest``).
"""

import numpy as np
import pytest
import torch

from semantic_embeddings_torch.embeddings import load_features, save_embeddings
from semantic_embeddings_torch.ops import conv1x1 as c1
from semantic_embeddings_torch.ops import conv3x3 as cc
from semantic_embeddings_torch.ops import cosine_loss as tc
from semantic_embeddings_torch.ops import topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, shape, dtype, zero_rows=0):
    return tc.check_inputs(shape, dtype, torch.Generator(device=device).manual_seed(0),
                           zero_rows)


@pytest.mark.parametrize("case", tc.CHECK_CASES + [((1, 1), 0), ((1000, 33), 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(device, case, dtype):
    shape, zero_rows = case
    tc.check_against_plain(*_inputs(device, shape, dtype, zero_rows))


def test_autograd_through_kernels(device):
    """``.mean()`` hands the backward a stride-0 g; one launch each way."""
    z, t, _ = _inputs(device, (100, 100), torch.float32)
    z.requires_grad_()
    before = (tc.launches_fwd, tc.launches_bwd)
    tc.fused_cosine_loss(z, t).mean().backward()
    torch.cuda.synchronize()
    assert (tc.launches_fwd, tc.launches_bwd) == (before[0] + 1, before[1] + 1)
    g = torch.full((100,), 1 / 100, device=device)
    torch.testing.assert_close(z.grad, tc._plain_backward(z.detach(), t, g),
                               **tc.CHECK_TOL[torch.float32]["dz"])


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    z, t, g = _inputs(device, (8, 6), torch.float32)
    with pytest.raises(TypeError):
        tc._launch_forward(z.double(), t)
    with pytest.raises(ValueError, match="one shape"):
        tc._launch_forward(z, t[:, :5])
    with pytest.raises(ValueError, match="contiguous"):
        tc._launch_forward(z.t(), t.t())
    with pytest.raises(ValueError, match="CUDA"):
        tc._launch_forward(z, t.cpu())
    with pytest.raises(ValueError, match="B, D >= 1"):
        tc._launch_forward(z[:0], t[:0])


def test_cli_trains_through_the_kernels(device, tmp_path):
    from semantic_embeddings_torch.cli import learn_image_embeddings

    rng = np.random.default_rng(0)
    e = rng.normal(size=(10, 64))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    save_embeddings(str(tmp_path / "emb.pickle"), list(range(10)), e)
    before = (tc.launches_fwd, tc.launches_bwd)
    state = learn_image_embeddings.main([
        "--dataset", "synthetic-10-64-32", "--data_root", str(tmp_path),
        "--embedding", str(tmp_path / "emb.pickle"), "--architecture", "resnet-32",
        "--cls_weight", "0.1", "--fused_loss", "--batch_size", "16",
        "--epochs", "1", "--feature_dump", str(tmp_path / "f.pickle"),
        "--device", "cuda"])
    assert state.step == 4
    assert (tc.launches_fwd - before[0], tc.launches_bwd - before[1]) == (4, 4)
    assert all(p.is_cuda for p in state.model.parameters())
    _, feats = load_features(str(tmp_path / "f.pickle"))
    assert feats.shape == (32, 64)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", cc.CHECK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_match_plain(device, case, dtype):
    torch.backends.cudnn.allow_tf32 = False
    cc.check_against_plain(*cc.check_inputs(
        case, dtype, torch.Generator(device=device).manual_seed(0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_are_deterministic(device, dtype):
    x, w, dy = cc.check_inputs((8, 14, 14, 64, 64), dtype,
                               torch.Generator(device=device).manual_seed(1))
    first = (*cc._launch_conv_bn_stats(x, w), cc._launch_filter_grad(x, dy))
    again = (*cc._launch_conv_bn_stats(x, w), cc._launch_filter_grad(x, dy))
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_filter_grad_copy_widths(device):
    """ALIGN_CASES give the bf16 kernel both of its copy paths: 16-byte
    copies (8 elements) where H*W % 8 == 0, else the repack (1): H*W = 196
    (% 8 == 4) and 49."""
    widths = []
    for case in cc.ALIGN_CASES:
        x, _, dy = cc.check_inputs(case, torch.bfloat16,
                                   torch.Generator(device=device).manual_seed(0))
        widths.append(cc.filter_grad_copy_width(x, dy))
    assert widths == [8, 1, 1]


def test_filter_grad_bf16_misaligned_pointers(device):
    """Operands that start 2 bytes past an aligned address fit no copy
    width even where H*W % 8 == 0: the kernel repacks them, and dw is the
    same bits as from aligned operands."""
    torch.backends.cudnn.allow_tf32 = False
    case = (4, 8, 8, 24, 80)
    x, w, dy = cc.check_inputs(case, torch.bfloat16,
                               torch.Generator(device=device).manual_seed(3))

    xs, dys = _shifted(x, 1), _shifted(dy, 1)
    assert cc.filter_grad_copy_width(xs, dys) == 1
    assert torch.equal(cc._launch_filter_grad(xs, dys), cc._launch_filter_grad(x, dy))
    cc.check_against_plain(xs, w, dys)


def _shifted(t, elements):
    """A copy of ``t`` that starts ``elements`` past an aligned address."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case, width", [((4, 8, 8, 24, 80), 4), ((4, 7, 7, 40, 72), 1),
                                         ((2, 13, 9, 16, 24), 1)])
def test_filter_grad_f32_copy_paths(device, case, width):
    """f32 planes take tensor copies where H*W % 4 == 0 (their strides must
    be whole 16 bytes), else a repack into planes padded to 8 floats (H*W =
    49, an odd ragged plane); dw holds against f64 on either path."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, dy = cc.check_inputs(case, torch.float32,
                               torch.Generator(device=device).manual_seed(6))
    assert cc.filter_grad_copy_width(x, dy) == width
    cc.check_against_plain(x, w, dy)


def test_filter_grad_f32_misaligned_pointers(device):
    """f32 operands 4 bytes past a 16-byte boundary are repacked even where
    H*W % 4 == 0, and give the same bits as aligned ones."""
    x, _, dy = cc.check_inputs((4, 8, 8, 24, 80), torch.float32,
                               torch.Generator(device=device).manual_seed(7))
    xs, dys = _shifted(x, 1), _shifted(dy, 1)
    assert cc.filter_grad_copy_width(xs, dys) == 1
    assert torch.equal(cc._launch_filter_grad(xs, dys), cc._launch_filter_grad(x, dy))


def test_conv_kernels_run_on_the_tensor_cores(device):
    """Both kernels run on Hopper's warpgroup wgmma, bf16 as bf16 and f32 as
    3xTF32 on TF32 wgmma."""
    assert cc.instance("conv3x3_filter_grad", torch.float32) == (
        "tensor cores: wgmma m64n64k8 3xTF32, 64 c x 64 f x 3 taps a warpgroup, "
        "3 warpgroups a block")
    assert cc.instance("conv3x3_filter_grad", torch.bfloat16) == (
        "tensor cores: wgmma m64n32k16 bf16, 64 f x 32 c x 9 taps a warpgroup, "
        "1 warpgroup a block where F <= 64, else 2")
    assert cc.instance("conv3x3_bn_stats", torch.bfloat16) == (
        "tensor cores: wgmma m64nNk16 bf16, 64 pixels x N f a warpgroup, N = 64 where F <= 64, "
        "else 128, 2 warpgroups a block")
    assert cc.instance("conv3x3_bn_stats", torch.float32) == (
        "tensor cores: wgmma m64nNk8 3xTF32, 64 pixels x N f a warpgroup, N = 64 where F <= 64, "
        "else 128, 2 warpgroups a block")


def test_wgmma_selftest_matches_matmul(device):
    """One wgmma of the bf16 filter gradient (A from registers, B through
    the MN-major no-swizzle descriptor started at whole 16-byte rows)
    against torch.matmul, at every start row of ``WGMMA_SELFTEST_CASES``."""
    assert cc.check_wgmma_selftest(torch.Generator(device=device).manual_seed(0)) <= 1e-5


def test_conv_wgmma_selftest_matches_matmul(device):
    """One wgmma of the bf16 conv + statistics kernel (A from registers, B
    the weight slice behind the K-major descriptor started at a tap's
    offset) against torch.matmul, at each N the kernel uses and taps 0, 4
    and 8; an N it does not use is refused."""
    assert cc.check_conv_wgmma_selftest(torch.Generator(device=device).manual_seed(0)) <= 1e-5
    a = torch.zeros((64, 16), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="tap"):
        cc.conv_wgmma_selftest(a, torch.zeros((9, 32, 16), dtype=torch.bfloat16, device=device), 0)


def test_tf32_selftest_matches_matmul(device):
    """The f32 filter gradient's TF32 wgmma chain on its own (x's A fragment
    split in registers, dy landed by 128-byte-swizzled tensor copies and
    split in shared memory, three wgmma a k8 slice, each step's products
    summed before an f32 add) against torch.matmul in f64, at chains of 1
    to 13 slices; an N other than the kernel's 64 and a bf16 operand are
    refused."""
    assert cc.check_tf32_selftest(torch.Generator(device=device).manual_seed(0)) <= 1e-5
    a = torch.zeros((64, 8), device=device)
    with pytest.raises(ValueError, match="64, K"):
        cc.tf32_selftest(a, torch.zeros((32, 8), device=device), cc.TF32_FLUSH_SLICES)
    with pytest.raises(TypeError):
        cc.tf32_selftest(a.bfloat16(), torch.zeros((64, 8), device=device).bfloat16(), 8)


def test_conv_tf32_selftest_matches_matmul(device):
    """The f32 conv + statistics kernel's TF32 wgmma chain on its own (A
    split in registers, the weight slice split in shared memory and read
    through the K-major descriptor started at each tap's offset, three wgmma
    a tap, each chunk's products summed before an f32 add) against
    torch.matmul in f64, at each N the kernel uses over 1 to 8 chunks; an N
    it does not use, a K that is not whole chunks and a bf16 operand are
    refused."""
    assert cc.check_conv_tf32_selftest(torch.Generator(device=device).manual_seed(0)) <= 1e-5
    a = torch.zeros((64, cc.CONV_TF32_CHUNK), device=device)
    with pytest.raises(ValueError, match="N in"):
        cc.conv_tf32_selftest(a, torch.zeros((32, cc.CONV_TF32_CHUNK), device=device), 1)
    with pytest.raises(ValueError, match="multiple"):
        cc.conv_tf32_selftest(a[:, :64], torch.zeros((64, 64), device=device), 1)
    with pytest.raises(TypeError):
        cc.conv_tf32_selftest(a.bfloat16(), torch.zeros_like(a).bfloat16(), 1)


@pytest.mark.parametrize("n", cc.CONV_WGMMA_N)
def test_conv_tf32_accumulation_depth(device, n):
    """Why the f32 conv adds each chunk's products to its running sums in
    f32: over 4,608 terms (a y of the 512-channel stage), products summed in
    the tensor cores one chunk (72 terms) at a time land within Y_OF_MAX / 4
    of max |d| from f64; all of them summed there land farther (3.2-3.5e-5
    on an H100, past Y_OF_MAX)."""
    errs = cc.conv_tf32_accumulation(torch.Generator(device=device).manual_seed(2), n)
    kernel = cc.CONV_TF32_CHUNK * cc.CONV_TF32_FLUSH
    assert errs[kernel] <= cc.Y_OF_MAX / 4, errs
    assert errs[0] > cc.Y_OF_MAX, errs


def test_tf32_accumulation_depth(device):
    """Why the f32 filter gradient adds each step's products to its running
    sums in f32: over 4,096 pixels (a block's share of a split), products
    summed in the tensor cores 8 to 64 pixels at a time land within
    DW_OF_MAX / 4 of max |d| from f64, the kernel's 64 among them; all
    4,096 summed there land farther than the kernel's depth (1.4-3.2e-5 on
    an H100, past DW_OF_MAX)."""
    errs = cc.tf32_accumulation(torch.Generator(device=device).manual_seed(1))
    kernel_depth = 8 * cc.TF32_FLUSH_SLICES
    assert all(errs[k] <= cc.DW_OF_MAX / 4 for k in (8, 16, 32, 64)), errs
    assert errs[0] > errs[kernel_depth], errs


def test_wgmma_selftest_rejects_rows_past_the_window(device):
    a = torch.zeros((64, 16), dtype=torch.bfloat16, device=device)
    b = torch.zeros((cc.WGMMA_B_ROWS, 32), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError, match="row"):
        cc.wgmma_selftest(a, b, cc.WGMMA_B_ROWS - 15)
    with pytest.raises(TypeError):
        cc.wgmma_selftest(a.float(), b.float(), 0)


@pytest.mark.parametrize("case, width", [((4, 8, 8, 24, 80), 4), ((3, 5, 10, 16, 40), 1),
                                         ((4, 7, 7, 40, 72), 1), ((2, 13, 9, 16, 24), 1)])
def test_conv_bn_stats_f32_copy_paths(device, case, width):
    """f32 x takes tensor copies of its planes where H*W % 4 == 0 (their
    strides must be whole 16 bytes), else a repack into planes padded to 8
    floats (H*W = 50, 49, an odd ragged plane); y holds against cuDNN and
    f64 on every path, and the statistics against their rounding bound."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, dy = cc.check_inputs(case, torch.float32,
                               torch.Generator(device=device).manual_seed(10))
    assert cc.conv_bn_stats_copy_width(x) == width
    cc.check_against_plain(x, w, dy)


@pytest.mark.parametrize("offset, width", [(2, 1), (1, 1)])
def test_conv_bn_stats_f32_misaligned_pointers(device, offset, width):
    """f32 x that starts 8 or 4 bytes past a 16-byte boundary is repacked
    even where H*W % 4 == 0 (a tensor copy needs 16-byte planes); y, s and
    ss are the same bits as from aligned x, and hold against the plain
    version."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, dy = cc.check_inputs((4, 8, 8, 24, 80), torch.float32,
                               torch.Generator(device=device).manual_seed(11))
    xs = _shifted(x, offset)
    assert cc.conv_bn_stats_copy_width(xs) == width
    for a, b in zip(cc._launch_conv_bn_stats(xs, w), cc._launch_conv_bn_stats(x, w)):
        assert torch.equal(a, b)
    cc.check_against_plain(xs, w, dy)


@pytest.mark.parametrize("case", [(4, 7, 7, 40, 72), (3, 5, 10, 16, 40), (2, 28, 28, 128, 136)])
def test_conv_bn_stats_f32_is_deterministic(device, case):
    """Two launches give the same bits of y, s and ss on the repack (H*W =
    49 and 50) and with F past one block."""
    x, w, _ = cc.check_inputs(case, torch.float32,
                              torch.Generator(device=device).manual_seed(12))
    first, again = cc._launch_conv_bn_stats(x, w), cc._launch_conv_bn_stats(x, w)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_conv_bn_stats_copy_widths(device):
    """ALIGN_CASES give the bf16 conv + statistics kernel both of its x
    paths: tensor copies of the planes (8 elements: H*W % 8 == 0), else the
    repack (1): H*W = 196 and 49."""
    widths = []
    for case in cc.ALIGN_CASES:
        x, _, _ = cc.check_inputs(case, torch.bfloat16,
                                  torch.Generator(device=device).manual_seed(0))
        widths.append(cc.conv_bn_stats_copy_width(x))
    assert widths == [8, 1, 1]


@pytest.mark.parametrize("offset, width", [(4, 1), (1, 1)])
def test_conv_bn_stats_bf16_misaligned_pointers(device, offset, width):
    """x that starts 8 or 2 bytes past a 16-byte boundary is repacked even
    where H*W % 8 == 0 (a tensor copy needs 16-byte planes); y, s and ss are
    the same bits as from aligned x, and hold against the plain version."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, dy = cc.check_inputs((4, 8, 8, 24, 80), torch.bfloat16,
                               torch.Generator(device=device).manual_seed(9))
    xs = _shifted(x, offset)
    assert cc.conv_bn_stats_copy_width(xs) == width
    for a, b in zip(cc._launch_conv_bn_stats(xs, w), cc._launch_conv_bn_stats(x, w)):
        assert torch.equal(a, b)
    cc.check_against_plain(xs, w, dy)


@pytest.mark.parametrize("autocast", [False, True])
def test_conv_autograd_launches_each_kernel_once(device, autocast):
    """One forward + backward through the op, in f32 and under bf16
    autocast: one launch of each kernel, on operands of that dtype."""
    x, w, _ = cc.check_inputs((2, 14, 14, 32, 64), torch.float32,
                              torch.Generator(device=device).manual_seed(8))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (cc.launches_conv_bn_stats, cc.launches_filter_grad)
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
        y, s, ss = cc.conv3x3_bn_stats(xg, wg)
    (y.float().sum() + s.sum() + ss.sum() * 0.01).backward()
    torch.cuda.synchronize()
    assert y.dtype == (torch.bfloat16 if autocast else torch.float32)
    assert (cc.launches_conv_bn_stats - before[0], cc.launches_filter_grad - before[1]) == (1, 1)
    assert torch.isfinite(wg.grad).all() and torch.isfinite(xg.grad).all()


def test_conv_autograd_bf16_through_the_tensor_core_kernel(device):
    """Under bf16 autocast one backward launches the filter-gradient kernel
    once, on bf16 operands; w's gradient is the kernel's dw on the op's own
    bf16 x and dy, rounded to the bf16 weight the op saw."""
    x, w, _ = cc.check_inputs((4, 14, 14, 32, 48), torch.float32,
                              torch.Generator(device=device).manual_seed(4))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    g = torch.randn((4, 48, 14, 14), device=device,
                    generator=torch.Generator(device=device).manual_seed(5))
    before = cc.launches_filter_grad
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y, _, _ = cc.conv3x3_bn_stats(xg, wg)
    assert y.dtype == torch.bfloat16
    (y.float() * g).sum().backward()
    torch.cuda.synchronize()
    assert cc.launches_filter_grad - before == 1
    direct = cc._launch_filter_grad(x.bfloat16(), g.bfloat16())
    assert wg.grad.dtype == torch.float32
    assert torch.equal(wg.grad, direct.bfloat16().float())


def test_conv_autograd_through_kernels(device):
    """One launch of each kernel per forward + backward; gradients equal
    the plain op's within the kernels' own tolerances."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, _ = cc.check_inputs((4, 14, 14, 32, 48), torch.float32,
                              torch.Generator(device=device).manual_seed(2))
    grads, launches = [], []
    for op in (cc.conv3x3_bn_stats, cc.plain_conv3x3_bn_stats):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = (cc.launches_conv_bn_stats, cc.launches_filter_grad)
        y, s, ss = op(xg, wg)
        (y.sin().sum() + s.sum() * 0.5 + ss.sum() * 0.01).backward()
        grads.append((xg.grad, wg.grad))
        launches.append((cc.launches_conv_bn_stats - before[0],
                         cc.launches_filter_grad - before[1]))
    torch.cuda.synchronize()
    assert launches == [(1, 1), (0, 0)]
    (dx, dw), (dx_p, dw_p) = grads
    torch.testing.assert_close(dx, dx_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, dw_p, rtol=0, atol=1e-4 * dw_p.abs().max().item())


@pytest.mark.parametrize("case", topk.CHECK_CASES)
def test_exact_topk_on_the_card_equals_the_cpu(device, case):
    """Tie-heavy rows and rows of +-inf: values and indices bitwise equal."""
    x = topk.check_inputs(case)
    _, _, k, chunk = case
    v, i = topk.exact_topk(x.to(device), k, chunk=chunk)
    v_cpu, i_cpu = topk.exact_topk(x, k, chunk=chunk)
    assert torch.equal(v.cpu(), v_cpu) and torch.equal(i.cpu(), i_cpu)


@pytest.mark.parametrize("prefix", [None, 250])
def test_ranking_on_the_card_equals_the_cpu(device, prefix):
    """The ranked class ids of both ranking paths (the full stable sort and
    the exact top-k), bitwise equal to the CPU's on tie-heavy inputs."""
    from semantic_embeddings_torch.evaluation import retrieval

    got = retrieval.ranking_check(device, prefix)
    assert got.shape == (512, 3999 if prefix is None else prefix)
    assert torch.equal(got, retrieval.ranking_check(torch.device("cpu"), prefix))


def test_retrieval_on_the_card_agrees_with_the_cpu(device, tmp_path):
    """evaluate_retrieval_features on the card and on the CPU: per-query
    values within 1e-5 (exact similarities; the cumulative sums differ in
    order only)."""
    from semantic_embeddings_torch.evaluation import retrieval
    from semantic_embeddings_torch.hierarchy import ClassHierarchy

    rng = np.random.default_rng(0)
    feats = rng.integers(-3, 4, (3000, 16)).astype(np.float32)
    labels = [int(c) for c in rng.integers(0, 100, 3000)]
    tree = tmp_path / "taxonomy.txt"
    tree.write_text("".join(f"200 {100 + s}\n" + "".join(
        f"{100 + s} {5 * s + leaf}\n" for leaf in range(5)) for s in range(20)))
    h = ClassHierarchy.from_file(str(tree), id_type=int)
    for kwargs in (dict(compute_ahp=True, compute_ap=True),
                   dict(compute_ahp=250, compute_ap=False)):
        _, on_card = retrieval.evaluate_retrieval_features(
            feats, labels, h, block_size=1024, device=device, **kwargs)
        _, on_cpu = retrieval.evaluate_retrieval_features(
            feats, labels, h, block_size=1024, device=torch.device("cpu"), **kwargs)
        for name in on_cpu:
            np.testing.assert_allclose(list(on_card[name].values()),
                                       list(on_cpu[name].values()), rtol=0, atol=1e-5)


def test_serving_fn_launches_the_conv_kernel(device, tmp_path):
    """A served rn18 forward runs through the conv + statistics kernel, 8
    launches a device call, and equals a direct eval forward."""
    from semantic_embeddings_torch.cli import common, serve_model
    from semantic_embeddings_torch.train.state import new_train_state, save_checkpoint

    model, _ = common.build_embedding_model(16, "rn18", "inv_corr", 0)
    path = str(tmp_path / "m.pt")
    save_checkpoint(path, new_train_state(model), {
        "architecture": "rn18", "embed_dim": 16, "loss": "inv_corr", "cls_classes": 0})
    srv = serve_model.make_server(serve_model.build_parser().parse_args(
        ["--checkpoint", path, "--input_size", "64", "--port", "0", "--max_batch", "4",
         "--layer", "l2norm"]))
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32)
    srv.start()
    try:
        before = cc.launches_conv_bn_stats
        got = srv.engine.predict(x, timeout=60)
        assert cc.launches_conv_bn_stats - before == 8
    finally:
        srv.stop()
    with torch.no_grad():
        direct = model.to(device).eval()(torch.from_numpy(x).to(device)).cpu().numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-5)


def test_conv_wrappers_reject_what_the_kernels_do_not_take(device):
    x, w, dy = cc.check_inputs((2, 5, 5, 4, 6), torch.float32,
                               torch.Generator(device=device).manual_seed(0))
    with pytest.raises(TypeError):
        cc._launch_conv_bn_stats(x.double(), w.double())
    with pytest.raises(TypeError):
        cc._launch_conv_bn_stats(x, w.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        cc._launch_conv_bn_stats(x, w[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cc._launch_conv_bn_stats(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="CUDA"):
        cc._launch_filter_grad(x, dy.cpu())
    with pytest.raises(ValueError, match="shape"):
        cc._launch_filter_grad(x, dy[:1])


# -- the kernels as torch.library custom ops ---------------------------------

OPS = torch.ops.semantic_embeddings_torch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_on_the_card(device, dtype):
    """The registrations hold for CUDA tensors too: each op's CUDA
    implementation against its fake and its autograd."""
    z, t, g = _inputs(device, (37, 100), dtype)
    torch.library.opcheck(tc.cosine_loss_fwd, (z.clone().requires_grad_(), t))
    torch.library.opcheck(tc.cosine_loss_bwd, (z, t, g))
    x, w, dy = cc.check_inputs((2, 14, 14, 32, 64), dtype,
                               torch.Generator(device=device).manual_seed(11))
    torch.library.opcheck(cc.conv3x3_bn_stats_op,
                          (x.clone().requires_grad_(), w.clone().requires_grad_()))
    torch.library.opcheck(cc.conv3x3_filter_grad, (x, dy))


def test_custom_ops_launch_the_kernels_once_each(device):
    """Each op on CUDA tensors launches its hand-written kernel once and
    returns what the kernel returns."""
    z, t, g = _inputs(device, (100, 100), torch.float32)
    before = (tc.launches_fwd, tc.launches_bwd)
    loss, dz = OPS.cosine_loss_fwd(z, t), OPS.cosine_loss_bwd(z, t, g)
    torch.cuda.synchronize()
    assert (tc.launches_fwd - before[0], tc.launches_bwd - before[1]) == (1, 1)
    assert torch.equal(loss, tc._launch_forward(z, t))
    assert torch.equal(dz, tc._launch_backward(z, t, g))
    x, w, dy = cc.check_inputs((4, 14, 14, 32, 48), torch.float32,
                               torch.Generator(device=device).manual_seed(12))
    before = (cc.launches_conv_bn_stats, cc.launches_filter_grad)
    outs, dw = OPS.conv3x3_bn_stats(x, w), OPS.conv3x3_filter_grad(x, dy)
    torch.cuda.synchronize()
    assert (cc.launches_conv_bn_stats - before[0], cc.launches_filter_grad - before[1]) == (1, 1)
    for a, b in zip(outs, cc._launch_conv_bn_stats(x, w)):
        assert torch.equal(a, b)
    assert torch.equal(dw, cc._launch_filter_grad(x, dy))


def _rn18_checkpoint(tmp_path, cls_classes=0):
    from semantic_embeddings_torch.cli import common
    from semantic_embeddings_torch.train.state import new_train_state, save_checkpoint

    model, _ = common.build_embedding_model(16, "rn18", "inv_corr", cls_classes)
    path = str(tmp_path / "rn18.pt")
    save_checkpoint(path, new_train_state(model), {
        "architecture": "rn18", "embed_dim": 16, "loss": "inv_corr",
        "cls_classes": cls_classes})
    return path, model


@pytest.mark.parametrize("bf16", [False, True])
def test_exported_rn18_launches_the_conv_kernel(device, tmp_path, bf16):
    """export_model on the card: the artifact holds 8 conv3x3_bn_stats
    nodes, launches the kernel 8 times a call at any batch, and equals the
    direct forward (f32 within 1e-5; bf16 within the JAX CLI's 2e-2)."""
    from semantic_embeddings_torch.cli import common, export_model

    path, model = _rn18_checkpoint(tmp_path)
    out = str(tmp_path / "rn18.pt2")
    sidecar = export_model.main(["--checkpoint", path, "--out", out, "--layer", "l2norm",
                                 "--input_size", "64", "--device", "cuda", "--validate",
                                 *(["--bf16"] if bf16 else [])])
    assert sidecar["custom_op_nodes"]["conv3x3_bn_stats"] == 8
    assert sidecar["platforms"] == ["cuda"]
    fn, _ = export_model.load_artifact(out, device)
    model = model.to(device).eval()
    for b in (1, 5):
        x = torch.randn(b, 64, 64, 3, device=device,
                        generator=torch.Generator(device=device).manual_seed(b))
        before = cc.launches_conv_bn_stats
        with torch.inference_mode():
            got = fn(x)
            torch.cuda.synchronize()
            assert cc.launches_conv_bn_stats - before == 8
            with common.maybe_autocast(device, torch.bfloat16 if bf16 else None):
                want = common.forward_tap(model, x, "l2norm").float()
        if bf16:
            torch.testing.assert_close(got, want, rtol=2e-2, atol=1e-3)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_serving_an_artifact_launches_the_conv_kernel(device, tmp_path):
    from semantic_embeddings_torch.cli import export_model, serve_model

    path, model = _rn18_checkpoint(tmp_path)
    out = str(tmp_path / "serve.pt2")
    export_model.main(["--checkpoint", path, "--out", out, "--layer", "l2norm",
                       "--input_size", "64", "--device", "cuda"])
    srv = serve_model.make_server(serve_model.build_parser().parse_args(
        ["--artifact", out, "--port", "0", "--max_batch", "4"]))
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32)
    srv.start()
    try:
        before = cc.launches_conv_bn_stats
        got = srv.engine.predict(x, timeout=60)
        assert cc.launches_conv_bn_stats - before == 8
    finally:
        srv.stop()
    with torch.no_grad():
        direct = model.to(device).eval()(torch.from_numpy(x).to(device)).cpu().numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-5)


# -- the baseline learners and --finetune on the card -----------------------


def _learner_argv(tmp_path, *extra):
    return ["--data_root", str(tmp_path), "--batch_size", "16", "--device", "cuda",
            "--no_progress", *extra]


def test_learn_classifier_on_the_card_through_both_conv_kernels(device, tmp_path):
    """rn18 at 64 px: 8 + 8 conv-kernel launches a step; the dump rebuilds
    and is evaluated on the card; --finetune from it runs both phases, the
    warm-up launching no filter gradient (the backbone is frozen)."""
    from semantic_embeddings_torch.cli import common, learn_classifier

    dump = str(tmp_path / "cls.pt")
    argv = _learner_argv(tmp_path, "--dataset", "synthetic-10-32-16-64", "--architecture",
                         "rn18", "--epochs", "1", "--label_smoothing", "0.1", "--bf16")
    before = (cc.launches_conv_bn_stats, cc.launches_filter_grad)
    state = learn_classifier.main(argv + ["--model_dump", dump])
    torch.cuda.synchronize()
    # 2 steps; fit's validation and the final one each run 1 test batch
    assert (cc.launches_conv_bn_stats - before[0], cc.launches_filter_grad - before[1]) == (
        8 * (2 + 2), 8 * 2)
    assert all(p.device.type == "cuda" for p in state.model.parameters())
    model, _ = common.rebuild_model_from_checkpoint(dump, device)
    assert type(model).__name__ == "ResNet"
    before = (cc.launches_conv_bn_stats, cc.launches_filter_grad)
    state = learn_classifier.main(argv + ["--finetune", dump, "--finetune_init", "1"])
    torch.cuda.synchronize()
    # phase 1: 2 frozen steps + 1 validation batch; phase 2: 2 steps + 2
    assert (cc.launches_conv_bn_stats - before[0], cc.launches_filter_grad - before[1]) == (
        8 * (3 + 4), 8 * 2)
    assert state.step == 2


@pytest.mark.parametrize("learner", ["devise", "labelembed", "center_loss",
                                     "center_loss_fixed", "finetune"])
def test_learner_clis_run_on_the_card(device, tmp_path, learner):
    """Each learner CLI through its steps on the card (`simple` at 32 px),
    its dump rebuilt reproducing its features within 1e-5; --finetune of
    the trainer launching the cosine pair once a step in both phases."""
    from semantic_embeddings_torch.cli import (
        common, learn_center_loss, learn_devise, learn_image_embeddings,
        learn_labelembedding)
    from semantic_embeddings_torch.data import get_data_generator

    rng = np.random.default_rng(0)
    e = rng.normal(size=(10, 64))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    emb = str(tmp_path / "emb.pickle")
    save_embeddings(emb, list(range(10)), e)
    base = _learner_argv(tmp_path, "--dataset", "synthetic-10-64-32", "--architecture",
                         "simple")
    dump, feat = str(tmp_path / "m.pt"), str(tmp_path / "f.pickle")
    init = str(tmp_path / "init.pt")
    learn_image_embeddings.main(base + ["--embedding", emb, "--epochs", "1", "--model_dump",
                                        init])
    outputs = ["--model_dump", dump, "--feature_dump", feat]
    before = (tc.launches_fwd, tc.launches_bwd)
    if learner == "devise":
        learn_devise.main(base + ["--embedding", emb, "--init_weights", init,
                                  "--init_epochs", "1", "--ft_epochs", "1", *outputs])
    elif learner == "labelembed":
        learn_labelembedding.main(base + ["--embed_dim", "64", "--epochs", "1", *outputs])
    elif learner == "center_loss":
        learn_center_loss.main(base + ["--embed_dim", "64", "--epochs", "1", *outputs])
    elif learner == "center_loss_fixed":
        state = learn_center_loss.main(base + ["--centroids", emb, "--epochs", "1", *outputs])
        np.testing.assert_array_equal(state.model.cls_centroids.detach().cpu().numpy(),
                                      e.astype(np.float32))
    else:
        learn_image_embeddings.main(base + ["--embedding", emb, "--epochs", "1",
                                            "--fused_loss", "--finetune", init,
                                            "--finetune_init", "1", *outputs])
        torch.cuda.synchronize()
        assert (tc.launches_fwd - before[0], tc.launches_bwd - before[1]) == (8, 8)
    _, feats = load_features(feat)
    assert np.isfinite(feats).all()
    model, _ = common.rebuild_model_from_checkpoint(dump, device)
    again = common.extract_test_features(model, get_data_generator("synthetic-10-64-32"),
                                         device, 16, pick=0)
    np.testing.assert_allclose(again, feats, rtol=0, atol=1e-5)


@pytest.mark.parametrize("color_mode", ["rgb", "bgr"])
def test_file_prepare_on_the_card_equals_the_cpu(device, tmp_path, color_mode):
    """A file dataset's device side (copy from pinned memory, color
    distortion, normalization, flips, erasing) on the card against the
    CPU's, for the same batch and the same draws.  Tolerance: the same f32
    operations; the per-image contrast mean sums in another order."""
    from _torch_files_common import write_nab

    from semantic_embeddings_torch.data.datasets import NABDataset

    root = write_nab(str(tmp_path))
    ds = NABDataset(root, cropsize=(40, 36), default_target_size=44, distort_colors=True,
                    randerase_prob=1.0, color_mode=color_mode)
    ds.colordistort_params = dict(ds.colordistort_params, fast_mode=False)  # all four orders
    ds.use_native = False  # the device side is under test; any host with Pillow
    raw = next(iter(ds.train_batches(6, epoch=0, seed=3)))
    assert raw["image"].is_pinned()
    b, h, w, _ = raw["image"].shape
    cpu_draws = ds.draw_augment(b, h, w, torch.Generator().manual_seed(1))

    def on(dev):
        return {
            "color": {k: v.to(dev) for k, v in cpu_draws["color"].items()},
            "flip": cpu_draws["flip"].to(dev),
            "erase": tuple(v.to(dev) for v in cpu_draws["erase"]),
        }

    ds.draw_augment = lambda *args: on("cpu")
    want, want_y = ds.make_prepare("cpu")(raw, None, True)
    ds.draw_augment = lambda *args: on(device)
    got, got_y = ds.make_prepare(device)(raw, None, True)
    assert got.device.type == "cuda" and got.shape == (b, h, w, 3)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got_y.cpu(), want_y)
    test = next(iter(ds.test_batches(6)))
    torch.testing.assert_close(ds.make_prepare(device)(test, None, False)[0].cpu(),
                               ds.make_prepare("cpu")(test, None, False)[0],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["unitsphere", "approx_sim"])
def test_compute_class_embedding_device_on_the_card(device, tmp_path, method):
    """``compute_class_embedding`` factors in float64 on the card, by
    default and on a bare ``--device`` (the JAX package's flag): E E^T
    within 1e-10 of the similarities, and of the ``--device cpu`` run's
    E E^T (not E itself: eigenvector signs differ between backends)."""
    from semantic_embeddings_torch.cli import compute_class_embedding
    from semantic_embeddings_torch.embeddings import load_embeddings
    from semantic_embeddings_torch.hierarchy import ClassHierarchy, semantic_distance_matrix

    edges = tmp_path / "h.txt"
    edges.write_text("".join(f"1000 {100 + g}\n" + "".join(
        f"{100 + g} {5 * g + c}\n" for c in range(5)) for g in range(8)))
    products = {}
    for name, extra in (("card", []), ("bare flag", ["--device"]),
                        ("host", ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.pickle")
        compute_class_embedding.main(["--hierarchy", str(edges), "--out", out,
                                      "--method", method, *extra])
        labels, emb = load_embeddings(out)
        products[name] = emb @ emb.T
    target = 1.0 - semantic_distance_matrix(ClassHierarchy.from_file(str(edges), id_type=int),
                                            labels)
    for name in ("card", "bare flag"):
        assert np.abs(products[name] - target).max() <= 1e-10
        assert np.abs(products[name] - products["host"]).max() <= 1e-10


# -- data parallelism on the card ---------------------------------------------


def test_fit_in_an_nccl_group_of_one_is_the_run_alone_bitwise(device, tmp_path):
    """Two rn18 steps through ``fit`` in a process under a launcher's
    environment of world size 1: in its NCCL group of one rank (the
    gradient reduce on, BatchNorm on its one-group path) every tensor is
    bitwise what the run without a group gives; the conv kernels launch
    as often."""
    import pickle

    import _torch_parallel_common as ranks
    from semantic_embeddings_torch import parallel

    out = tmp_path / "out.pickle"
    parallel.launch(ranks.cuda_fit_alone_and_grouped, 1, str(out))
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["backend"] == "nccl" and got["unequal"] == []
    # 8 fused convs of rn18: 2 steps + 1 validation batch; filter gradients 2 steps
    assert got["launches"] == [[24, 16], [24, 16]]


def test_two_gloo_ranks_on_the_card_match_one_process(device, tmp_path):
    """One rn18 step on two gloo ranks sharing cuda:0, sync BN, each on 8
    of the batch's 16 rows, against the one-process step on all 16, both
    held to the one-process step in f64 (plain versions), as
    ``chip_smoke.py`` phase 16b holds them: no tensor of the two-rank step
    farther from f64, in units of its f64 update, than twice the
    one-process f32 step's farthest (early layers' f32 updates sit a few
    percent of the update from f64 on any path).  Both ranks end bitwise
    equal; each rank launches both conv kernels 8 times."""
    import copy
    import pickle

    import _torch_parallel_common as ranks
    from semantic_embeddings_torch import parallel
    from semantic_embeddings_torch.models.resnet import use_plain_conv_bn_stats
    from semantic_embeddings_torch.train import new_train_state

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int64)}
    model, spec = ranks.cuda_model(0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    case = {"state": {k: v.cpu().numpy() for k, v in before.items()}, "batch": batch}
    with open(tmp_path / "case.pickle", "wb") as f:
        pickle.dump(case, f)
    parallel.launch(ranks.cuda_two_ranks_step, 2, str(tmp_path / "case.pickle"),
                    str(tmp_path / "out.pickle"))
    with open(tmp_path / "out.pickle", "rb") as f:
        got = pickle.load(f)
    assert got["ranks_equal"] and got["launches"] == [8, 8]

    model_64 = copy.deepcopy(model)
    use_plain_conv_bn_stats(model_64)
    model_64.double()
    steps = {}
    for name, m, dtype in (("f32", model, torch.float32), ("f64", model_64, torch.float64)):
        def prepare(raw, rng, train, dtype=dtype):
            return (torch.from_numpy(raw["x"]).to("cuda", dtype),
                    torch.from_numpy(raw["y"]).cuda())

        state, _ = ranks.cuda_step(m, spec, prepare, plain=dtype == torch.float64)(
            new_train_state(m), batch, 0.1, None)
        steps[name] = {k: v.double().cpu() for k, v in state.model.state_dict().items()}
    two = {k: torch.from_numpy(v).double() for k, v in got["state"].items()}
    params = {n for n, _ in model.named_parameters()}

    def distance(sd, n):
        scale = (steps["f64"][n] - before[n].double().cpu()).abs().max().item() if n in params \
            else 1.0
        return (sd[n] - steps["f64"][n]).abs().max().item() / max(scale, 1e-30)

    for names in (params, set(before) - params):
        worst = max(distance(steps["f32"], n) for n in names)
        far = {n: distance(two, n) for n in names if distance(two, n) > 2 * worst + 1e-7}
        assert not far, (far, worst)


def test_learner_cli_on_every_card_matches_one_card(device, tmp_path):
    """``learn_image_embeddings --gpus N``, N the visible cards (two or
    more): the CLI spawns one rank a card, joined by NCCL; after one step
    of ``simple`` on a global batch of 8 N its model dump, written by rank
    0, against ``--gpus 1``'s within rounding (four gloo ranks on the CPU:
    2.4e-7)."""
    from semantic_embeddings_torch.cli import common, learn_image_embeddings

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")

    def argv(out, gpus):
        return ["--dataset", f"synthetic-4-{8 * n}-16-16", "--data_root", str(tmp_path),
                "--embedding", "onehot", "--architecture", "simple",
                "--batch_size", str(8 * n), "--epochs", "1", "--lr_schedule", "SGD",
                "--sgd_lr", "0.05", "--no_progress", "--gpus", str(gpus),
                "--model_dump", str(tmp_path / f"{out}.pt")]

    learn_image_embeddings.main(argv("one", 1))
    assert learn_image_embeddings.main(argv("all", n)) is None
    one, _ = common.load_checkpoint_raw(str(tmp_path / "one.pt"))
    every, _ = common.load_checkpoint_raw(str(tmp_path / "all.pt"))
    for k in one:
        np.testing.assert_allclose(every[k].numpy(), one[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# -- spatial partitioning: halo rows, and --spatial over NCCL -----------------


@pytest.mark.parametrize("case", cc.HALO_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_kernels_match_plain_and_the_whole_image(device, case, dtype):
    """Both kernels on each row block of the 448-px recipe's stage shapes at
    S = 2 (and stage 4 at S = 4, blocks of 4, 4, 4, 2 rows) with the halo
    rows: against their plain halo versions, y bitwise the whole-image
    launch's rows, the blocks' sums and dw added up the whole image's
    (``check_halo_shards``' bounds)."""
    torch.backends.cudnn.allow_tf32 = False
    before = (cc.launches_conv_bn_stats_halo, cc.launches_filter_grad_halo)
    x, w, dy = cc.check_inputs(case[:5], dtype, torch.Generator(device=device).manual_seed(0))
    got = cc.check_halo_shards(x, w, dy, case[5])
    assert got["y_vs_whole_bitwise"]
    blocks = len(cc.row_shards(x, case[5]))
    assert (cc.launches_conv_bn_stats_halo - before[0],
            cc.launches_filter_grad_halo - before[1]) == (blocks, blocks)


@pytest.mark.parametrize("gpus", [2, 4])
def test_spatial_grid_over_nccl_matches_one_card(device, tmp_path, gpus):
    """``learn_image_embeddings --gpus G --spatial 2`` (a (G / 2, 2) grid,
    one rank a card, NCCL; the halo rows of rn18's convs and every
    ``conv_b``'s kernels exchanged between cards): after one step on a
    global batch of 16 at 32 px its model dump against ``--gpus 1``'s.  The
    bound is f32's on the card, not the CPU's (1.3e-7 there with gloo
    ranks): cuDNN picks its algorithms by shape, so a block of rows rounds
    otherwise than the whole image, and an f32 ResNet step on the card lies
    up to 0.06-0.07 of a tensor's update from the f64 step (chip_smoke 16b,
    17b), either run; so each parameter within a quarter of its one-card
    update, which a wrong halo row or a gradient off by a factor of S
    exceeds; the running statistics within 1e-4 relative."""
    from semantic_embeddings_torch.cli import common, learn_image_embeddings

    if torch.cuda.device_count() < gpus:
        pytest.skip(f"needs {gpus} cards")

    def argv(out, *flags):
        return ["--dataset", "synthetic-4-16-16-32", "--data_root", str(tmp_path),
                "--embedding", "onehot", "--architecture", "rn18", "--batch_size", "16",
                "--epochs", "1", "--lr_schedule", "SGD", "--sgd_lr", "0.05",
                "--no_progress", "--model_dump", str(tmp_path / f"{out}.pt"), *flags]

    learn_image_embeddings.main(argv("one"))
    assert learn_image_embeddings.main(argv("grid", "--gpus", str(gpus),
                                            "--spatial", "2")) is None
    one, _ = common.load_checkpoint_raw(str(tmp_path / "one.pt"))
    grid, _ = common.load_checkpoint_raw(str(tmp_path / "grid.pt"))
    # the CLI's initial weights (4-d one-hot embedding, seed 0)
    before = common.build_embedding_model(4, "rn18", "inv_corr", 0, seed=0)[0].state_dict()
    assert sorted(one) == sorted(grid) == sorted(before)
    ratios = {k: (grid[k] - one[k]).abs().max().item()
              / max((one[k] - before[k]).abs().max().item(), 1e-30)
              for k in one if "running_" not in k}
    print("largest gap in units of the update:", max(ratios.values()),
          max(ratios, key=ratios.get))
    for k in one:
        if "running_" in k:
            np.testing.assert_allclose(grid[k].numpy(), one[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            continue
        update = (one[k] - before[k]).abs().max().item()
        gap = (grid[k] - one[k]).abs().max().item()
        assert gap <= 0.25 * update + 1e-7, (k, gap, update)


# -- the 1x1 convs' f32 weight gradient ---------------------------------------


@pytest.fixture
def gen(device):
    return torch.Generator(device=device).manual_seed(0)


@pytest.mark.parametrize("shape", [shape for shape, _ in c1.RESNET50_SHAPES])
def test_conv1x1_filter_grad_at_resnet50_shapes(device, gen, shape):
    """dw within ``DW_OF_MAX`` of max |dw| of an f64 matrix product, and
    bitwise the same over two launches, at batch 128."""
    c, f, ho, stride = shape
    x, dy = c1.check_inputs(128, c, f, ho * stride, ho * stride, stride, gen)
    c1.check_against_f64(x, dy, stride)


@pytest.mark.parametrize("case", c1.RAGGED_CASES)
def test_conv1x1_filter_grad_ragged(device, gen, case):
    c1.check_against_f64(*c1.check_inputs(*case, gen), case[-1])


def test_conv1x1_filter_grad_misaligned_operand(device, gen):
    """x one float into its storage: the threads' loads take it."""
    x = torch.randn(1 + 2 * 64 * 8 * 8, generator=gen, device=device)[1:].view(2, 64, 8, 8)
    dy = torch.randn(2, 128, 8, 8, generator=gen, device=device)
    assert "threads' loads" in c1.instance(x, dy, 1)
    c1.check_against_f64(x, dy, 1)


def test_conv1x1_filter_grad_launches_36_a_resnet50_step(device, gen):
    """36 launches in an f32 train step (16 conv_a, 16 conv_c, 4 shortcuts),
    none in a bf16 step or an inference forward."""
    from semantic_embeddings_torch.models import build_network

    model = build_network(10, "resnet-50", generator=torch.Generator().manual_seed(0))
    model = model.module.to(device)
    x = torch.randn(2, 64, 64, 3, generator=gen, device=device)
    before = c1.launches_filter_grad
    model(x).sum().backward()
    torch.cuda.synchronize()
    assert c1.launches_filter_grad - before == 36
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = model(x).float().sum()
    loss.backward()
    with torch.no_grad():
        model(x)
    assert c1.launches_filter_grad - before == 36


def test_conv1x1_op_and_its_wrapper_on_the_card(device, gen):
    x, dy = c1.check_inputs(2, 64, 128, 8, 8, 2, gen)
    torch.library.opcheck(c1.conv1x1_filter_grad, (x, dy, 2))
    with pytest.raises(TypeError):
        c1._launch_filter_grad(x.double(), dy.double(), 2)
    with pytest.raises(ValueError, match="output"):
        c1._launch_filter_grad(x, dy, 1)
    with pytest.raises(ValueError, match="contiguous"):
        c1._launch_filter_grad(x.transpose(2, 3), dy.transpose(2, 3), 2)
