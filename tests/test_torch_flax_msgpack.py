"""The port's pure-Python Flax msgpack reader and writer against
``flax.serialization``: the writer's bytes equal ``msgpack_serialize``'s,
bit for bit, and the reader gives ``msgpack_restore``'s tree (bfloat16
leaves as ``torch.bfloat16`` tensors), for float32, bfloat16, integer and
scalar leaves, nested maps, lists, and a chunked leaf; the port imports
with JAX, flax and msgpack blocked."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from semantic_embeddings_torch.train import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    """A tree of every leaf kind flax writes, from the seed."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "conv0": {"kernel": rng.normal(size=(3, 3, 3, 16)).astype(np.float32)},
            "top": {"kernel": rng.normal(size=(64, 10)).astype(np.float32),
                    "bias": np.zeros(10, np.float32)},
        },
        "bf16": {"w": rng.normal(size=(5, 7)).astype(ml_dtypes.bfloat16)},
        "ints": {"i32": rng.integers(-9, 9, (4,)).astype(np.int32),
                 "u8": rng.integers(0, 255, (2, 3)).astype(np.uint8),
                 "i64": np.arange(3, dtype=np.int64), "empty": np.zeros((0, 2), np.float32)},
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7), "bool": np.bool_(True),
                    "bf16": ml_dtypes.bfloat16(1.25)},
        "python": {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1],
                   "float": 0.1, "none": None, "true": True, "false": False,
                   "str": "x" * 40, "long_str": "y" * 300, "bytes": b"\x00\xff" * 200,
                   "complex": complex(1.5, -2.0), "empty": {}, "list": [1, "a", [2.0]]},
        "step": 12,
        "wide": {f"k{i:02d}": i for i in range(20)},  # a map of more than 15 entries
        "f64": rng.normal(size=(70_000,)),  # a bin of more than 65,535 bytes
    }


def _as_port(tree):
    """The same tree with ml_dtypes bfloat16 leaves as torch.bfloat16."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return tree


def _assert_same(want, got, path=""):
    """``got`` (the port's restore) holds ``want`` (flax's) bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            _assert_same(want[key], got[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{path}/{i}")
    elif np.asarray(want).dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("in_place", [False, True])
def test_writer_bytes_equal_flax(in_place):
    want = serialization.msgpack_serialize(_tree(), in_place=in_place)
    assert flax_msgpack.msgpack_serialize(_tree(), in_place=in_place) == want
    # torch tensors (bfloat16 among them) write as their numpy arrays
    assert flax_msgpack.msgpack_serialize(_as_port(_tree()), in_place=in_place) == want


@pytest.mark.parametrize("in_place", [False, True])
def test_reader_equals_flax_restore(in_place):
    data = serialization.msgpack_serialize(_tree(1), in_place=in_place)
    _assert_same(serialization.msgpack_restore(data), flax_msgpack.msgpack_restore(data))


def test_chunked_leaves(monkeypatch):
    """A leaf of more than MAX_CHUNK_SIZE bytes goes out in chunks (a map at
    the top level and in maps, never in lists) and comes back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(2)
    tree = {"a": {"w": rng.normal(size=(20, 30)).astype(np.float32)},
            "bf": rng.normal(size=(900,)).astype(ml_dtypes.bfloat16),
            "odd": rng.normal(size=(251,)).astype(np.float32),
            "in_list": [rng.normal(size=(400,)).astype(np.float32)]}
    want = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in want
    assert flax_msgpack.msgpack_serialize(tree) == want
    assert flax_msgpack.msgpack_serialize(_as_port(tree)) == want
    _assert_same(serialization.msgpack_restore(want), flax_msgpack.msgpack_restore(want))
    top = rng.normal(size=(600,)).astype(np.float32)  # chunked at the top level
    want = serialization.msgpack_serialize(top)
    assert flax_msgpack.msgpack_serialize(top) == want
    _assert_same(serialization.msgpack_restore(want), flax_msgpack.msgpack_restore(want))


def test_restored_arrays_are_views_of_the_input():
    data = serialization.msgpack_serialize({"w": np.arange(1000, dtype=np.float32)})
    w = flax_msgpack.msgpack_restore(data)["w"]
    assert not w.flags.writeable and not w.flags.owndata


@pytest.mark.parametrize("data,match", [(b"\x81\xa1a", "truncated"),
                                        (b"\x80\x00", "bytes after"),
                                        (b"\xc1", "not valid")])
def test_malformed_input_raises(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(data)


def test_unknown_ext_code_and_unserializable_leaf():
    with pytest.raises(ValueError, match="ext code 7"):
        flax_msgpack.msgpack_restore(b"\xd4\x07\x2a")  # fixext 1, code 7
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.msgpack_serialize({"t": (1, 2)})


def test_port_imports_with_jax_flax_msgpack_blocked(tmp_path):
    """Every module of the port imports, and a flax-written file reads and
    writes back, with ``jax``, ``flax``, ``msgpack`` and the JAX package
    blocked in ``sys.modules`` (an import of any of them raises)."""
    path = tmp_path / "tree.msgpack"
    tree = {"params": _tree(3)["params"], "step": 3}
    path.write_bytes(serialization.msgpack_serialize(tree))
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'semantic_embeddings_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import semantic_embeddings_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from semantic_embeddings_torch.train import flax_msgpack as fm\n"
        "data = open(sys.argv[1], 'rb').read()\n"
        "tree = fm.msgpack_restore(data)\n"
        "assert fm.msgpack_serialize(tree) == data\n"
        "print(len(names), tree['step'])\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[1] == "3" and int(out.stdout.split()[0]) >= 40
