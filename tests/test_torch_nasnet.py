"""The port's NASNet-A against the JAX package's, small (one normal cell a
stage, 96 penultimate filters, 8 stem filters; 48 would give the first stem
cell 48 // 24 // 4 = 0 filters, which the JAX module cannot build either)
at 32 px, from the same
weights and inputs: eval and train forwards, the new running statistics and
float64 gradients (tolerances in ``_torch_zoo_common``); and the cell
wiring that only shows in the structure (which cells adjust their p input,
and how)."""

import numpy as np
import pytest
import torch

from _torch_zoo_common import check_forward, check_gradients, images, pair, reference
from semantic_embeddings_tpu.models.nasnet import NASNetA as JNASNetA
from semantic_embeddings_torch.models.nasnet import NASNetA

SMALL = dict(classes=10, num_normal_cells=1, penultimate_filters=96, stem_filters=8)


# At 32 px the last stage's maps are 1x1, so the train forward's BatchNorms
# there normalize 4 values a channel, which amplifies f32 rounding: JAX's
# own f32 train output sits 1.2e-5 of max |out| from its f64 one here, and
# the port's f32 one 0.3-1.4e-5 from JAX's, by the order of the sums.  The
# f32 train output is held to 1e-4; the f64 one to 1e-10.
TRAIN_F32_OF_MAX = 1e-4


@pytest.fixture(scope="module")
def nasnet():
    jmodule, tmodule = JNASNetA(**SMALL), NASNetA(**SMALL)
    x = images((4, 32, 32, 3))
    variables = pair(jmodule, tmodule, x)
    return tmodule, variables, reference(jmodule, variables, x)


def test_nasnet_forward_and_stats_match_jax(nasnet):
    check_forward(*nasnet, train_of_max=TRAIN_F32_OF_MAX)


def test_nasnet_gradients_match_jax_f64(nasnet):
    check_gradients(*nasnet)


def test_nasnet_cell_wiring():
    """The adjustment of each cell's p input, as Flax chooses it at trace
    time: none for the first stem cell (p is its raw input), a factorized
    reduce after every reduction (p from two cells back is larger), a
    squeeze where only the channels differ, and none where they agree."""
    model = NASNetA(**SMALL)
    rules = {name: getattr(model, name).rule for name, _ in model.cells}
    assert rules == {"cell_stem_1": "absent", "cell_stem_2": "factorize",
                     "cell_0": "factorize", "cell_reduce_1": None,
                     "cell_2": "factorize", "cell_reduce_2": "squeeze",
                     "cell_3": "factorize"}
    advances = [advance for _, advance in model.cells]
    assert advances == [True, True, True, False, True, False, True]
    with pytest.raises(ValueError, match="too small"):
        model.eval()(torch.zeros(1, 8, 8, 3))


def test_nasnet_large_cell_names_and_width():
    """NASNetLarge's Keras block ids, and 4032 features into the top."""
    with torch.device("meta"):
        model = NASNetA(classes=1000)
    names = [name for name, _ in model.cells]
    assert names[:3] == ["cell_stem_1", "cell_stem_2", "cell_0"]
    assert names[8] == "cell_reduce_6" and names[9] == "cell_7"
    assert names[15] == "cell_reduce_12" and names[-1] == "cell_18"
    assert len(names) == 2 + 2 + 18 and model.top.in_features == 4032
    n = sum(p.numel() for p in model.parameters())
    assert np.isclose(n, 88.9e6, rtol=0.01), n
