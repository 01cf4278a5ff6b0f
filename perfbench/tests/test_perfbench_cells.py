"""The harness finds every configuration, traffic mix, check and metric of
``BENCHMARK.json`` by name, and each configuration's reference builds the
program's parameter tree."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name, traced):
    cell = harness.load_cell(name, traced)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.chips == entry["chips"]
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["batch"] % cell.chips == 0
    # the first three steps train on rows that all differ
    assert cell.traffic["resident_images"] >= 3 * cell.traffic["batch"]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    kind = "per_layer" if traced else "end_to_end"
    listed = [m["name"] for m in BENCH[kind] if name in m.get("workloads", [name])]
    assert list(cell.metrics) == listed
    for metric in listed:
        assert callable(harness.reader(metric))


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(metric["name"]))
    for name in CELLS:
        e2e = harness.load_cell(name, False).metrics
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.load_cell(name, True).metrics


@pytest.mark.parametrize("config,classes,parameters", [
    ("resnet50", 1000, 23_508_032), ("resnet110wfc", 100, 6_892_192)])
def test_reference_tree_is_the_programs(config, classes, parameters):
    """The reference's names and shapes are the program's ``state_dict``'s
    (weights made for one load strictly into the other), and the backbone
    holds its published parameter count (without its top)."""
    import importlib

    from semantic_embeddings_torch.models import EmbeddingModel, build_network

    config = json.loads((harness.HERE / "configs" / f"{config}.json").read_text())
    reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
    shapes = reference.shapes(config, classes)
    with torch.device("meta"):
        spec = build_network(classes, config["architecture"])
        model = EmbeddingModel(spec.module, output="l2norm", cls_classes=classes)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in shapes.items()}
    backbone = sum(torch.Size(s).numel() for n, (s, k) in shapes.items()
                   if n.startswith("backbone.") and not n.startswith("backbone.top.")
                   and k not in ("mean", "var"))
    assert backbone == parameters


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    """``semantic_embeddings_torch`` begins with the JAX package's name and
    is allowed; ``jax.numpy`` counts as ``jax``; ``jaxtyping`` does not."""
    for name in ("semantic_embeddings_torch", "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == sorted(
        n for n in harness.FORBIDDEN if n in {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_a_run_imports_no_jax_and_the_reference_nothing_of_the_program():
    """In a fresh process: the reference imports neither JAX nor anything of
    the program; the harness with the program's modules loads no JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.reference import plain, resnet50, resnet110wfc\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'optax', 'semantic_embeddings_tpu',"
        " 'semantic_embeddings_torch'}, tops\n"
        "from perfbench import harness, program, checks\n"
        "program.launch_counters()\n"
        "import semantic_embeddings_torch.cli.common, semantic_embeddings_torch.train\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
    ) % str(harness.ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_run_py_refuses_without_enough_cards(tmp_path):
    """No card (or fewer than the cell asks for): exit code 2 and no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", CELLS[0],
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
