"""CLI: export a trained model as a ``torch.export`` serving artifact.

The PyTorch counterpart of the JAX package's ``cli/export_model.py``: the
inference function (the eval-mode forward at a chosen feature tap, weights
baked in) is traced once with ``torch.export.export`` and written with
``torch.export.save`` as a ``.pt2`` file, with a ``.json`` sidecar that
describes its input.  Run it as ``python -m
semantic_embeddings_torch.cli.export_model``:

    python -m semantic_embeddings_torch.cli.export_model --checkpoint model.pt \\
        --out model.pt2 --layer l2norm --input_size 224 [--batch -1] [--validate]

- The artifact takes (B, H, W, C) float32 images, as the JAX artifact does,
  and returns float32.  The batch dimension is symbolic by default
  (``--batch -1``): one artifact serves any batch size up to
  :data:`MAX_BATCH`.
- ``--layer`` picks the feature tap as ``evaluate_classification_accuracy
  --layer`` does (l2norm / embedding / prob / avg_pool); default: the
  model's final output.
- The graph keeps the port's custom ops as nodes (an ImageNet ResNet holds
  one ``semantic_embeddings_torch::conv3x3_bn_stats`` per block), so that
  the loaded artifact launches the hand-written kernels on the card.
  Loading it therefore needs the ops registered: import
  ``semantic_embeddings_torch.ops`` first (the JAX package's StableHLO
  artifact needs no package).
- ``--bf16`` bakes bfloat16 compute in: the forward runs under
  ``torch.autocast``, which ``torch.export`` keeps in the graph as an
  autocast region (``wrap_with_autocast``).  The region names the device
  type it was exported on; export on the kind of device that will serve.
- ``--validate`` loads the artifact back and compares it with the direct
  forward.

Loading at serving time:

    import torch
    import semantic_embeddings_torch.ops  # registers the custom ops
    fn = torch.export.load("model.pt2").module()
    embeddings = fn(images)               # (B, H, W, C) float32
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch import nn

#: the largest batch a batch-polymorphic artifact takes
MAX_BATCH = 65535
#: --validate tolerances: f32 runs the same kernels as the direct forward;
#: bf16 is held as the JAX package holds it (export_model.py there)
VALIDATE_TOL = {"float32": dict(rtol=0.0, atol=1e-5),
                "bfloat16": dict(rtol=2e-2, atol=1e-3)}


def build_parser():
    parser = argparse.ArgumentParser(
        description="Exports a trained checkpoint as a torch.export serving "
                    "artifact (.pt2).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Model dump written by the learners "
                             "(--model_dump / --snapshot).")
    parser.add_argument("--architecture", type=str, default=None,
                        help="Backbone architecture (only needed when the "
                             "checkpoint lacks metadata).")
    parser.add_argument("--out", type=str, required=True,
                        help="Output artifact path; a .json sidecar with "
                             "the input spec is written next to it.")
    parser.add_argument("--layer", type=str, default=None,
                        help="Feature tap to export (l2norm / embedding / "
                             "prob / avg_pool); default: final output.")
    parser.add_argument("--input_size", type=int, default=32,
                        help="Input image height/width.")
    parser.add_argument("--input_channels", type=int, default=3)
    parser.add_argument("--batch", type=int, default=-1,
                        help="Batch size to specialize for; -1 exports a "
                             "batch-polymorphic artifact.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to export on and for (cuda, cuda:N or "
                             "cpu). A CUDA device that is not present is an "
                             "error.")
    parser.add_argument("--validate", action="store_true", default=False,
                        help="Load the artifact back and compare it with the "
                             "direct forward on this device.")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="Bake bfloat16 compute (torch.autocast) into the "
                             "artifact; inputs and outputs stay float32.")
    return parser


class ServingForward(nn.Module):
    """The eval-mode forward at a tap: (B, H, W, C) float32 images in,
    float32 out (a tuple for a model with several outputs and no tap);
    under ``torch.autocast`` to ``autocast_dtype`` when it is given."""

    def __init__(self, model, layer=None, autocast_dtype=None):
        super().__init__()
        self.model = model
        self.layer = layer
        self.autocast_dtype = autocast_dtype

    def forward(self, images):
        from . import common

        with common.maybe_autocast(images.device, self.autocast_dtype):
            out = common.forward_tap(self.model, images, self.layer) \
                if self.layer is not None else self.model(images)
        if isinstance(out, tuple):
            return tuple(t.float() for t in out)
        return out.float()


def count_op_nodes(program, name):
    """Call nodes of ``program``'s graphs (autocast regions' subgraphs too)
    whose target names ``name``, e.g. ``"conv3x3_bn_stats"``."""
    graph_module = getattr(program, "graph_module", program)
    return sum(1 for m in graph_module.modules() if isinstance(m, torch.fx.GraphModule)
               for node in m.graph.nodes
               if node.op == "call_function" and name in str(node.target))


def load_artifact(path, device=None):
    """``(callable, sidecar)`` of an artifact: the loaded program's module,
    on ``device`` if given, and the sidecar's fields (an empty dict when
    there is no sidecar).  Registers the port's custom ops first."""
    from .. import ops  # noqa: F401  (registers the ops the graph calls)

    program = torch.export.load(path)
    fn = program.module()
    if device is not None:
        fn = fn.to(device)
    sidecar = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            sidecar = json.load(f)
    return fn, sidecar


def export_checkpoint(checkpoint, out, device, architecture=None, layer=None,
                      input_size=32, input_channels=3, batch=-1, validate=False,
                      bf16=False):
    """Exports ``checkpoint``'s forward at ``layer`` to ``out`` (.pt2) and
    its sidecar to ``out + '.json'``; returns the sidecar's fields, with
    the export's seconds under ``export_s``."""
    from . import common

    model, meta = common.rebuild_model_from_checkpoint(checkpoint, device, architecture)
    compute = "bfloat16" if bf16 else "float32"
    forward = ServingForward(model, layer, torch.bfloat16 if bf16 else None).eval()
    example = torch.zeros((2 if batch == -1 else batch, input_size, input_size,
                           input_channels), dtype=torch.float32, device=device)
    # at most MAX_BATCH images a call: the bound under which the card's
    # f32 batch norm takes cuDNN's kernels, a guard the trace records
    dynamic = ({0: torch.export.Dim("batch", max=MAX_BATCH)},) if batch == -1 else None
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(forward, (example,), dynamic_shapes=dynamic)
    torch.export.save(program, out)
    export_s = time.perf_counter() - t0
    sidecar = {
        "architecture": meta.get("architecture", architecture),
        "layer": layer,
        "input_shape": [batch, input_size, input_size, input_channels],
        "input_dtype": "float32",
        "compute_dtype": compute,
        "platforms": [device.type],
        "embed_dim": meta.get("embed_dim"),
        "cls_classes": meta.get("cls_classes"),
        "learner": meta.get("learner"),
        "checkpoint": checkpoint,
        "torch_version": torch.__version__,
        "load_requires": "import semantic_embeddings_torch.ops (registers the "
                         "custom ops the graph calls)",
        "custom_op_nodes": {name: count_op_nodes(program, name)
                            for name in ("conv3x3_bn_stats", "cosine_loss_fwd")},
    }
    with open(out + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    print(f"Exported {out} ({compute}, {device.type}, batch "
          f"{'symbolic' if batch == -1 else batch}) in {export_s:.2f} s; custom-op "
          f"nodes {sidecar['custom_op_nodes']}")

    if validate:
        fn, _ = load_artifact(out, device)
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.normal(size=tuple(example.shape)).astype(np.float32),
                            device=device)
        with torch.no_grad():
            got, want = fn(x), forward(x)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g, w, **VALIDATE_TOL[compute])
        print("Validated: the loaded artifact matches the direct forward.")
    return {**sidecar, "export_s": export_s}


def main(argv=None):
    from . import common

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    common.set_float32_precision()
    return export_checkpoint(
        args.checkpoint, args.out, device, architecture=args.architecture,
        layer=args.layer, input_size=args.input_size,
        input_channels=args.input_channels, batch=args.batch,
        validate=args.validate, bf16=args.bf16)


if __name__ == "__main__":
    main()
