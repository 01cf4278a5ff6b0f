"""CLI: export a checkpoint as a Keras ``.h5`` weights file the reference
loads (the counterpart of the JAX package's ``cli/export_keras_weights.py``).

The inverse of :mod:`import_keras_weights`: a model trained with the port
(or with the JAX package) becomes a weights file for the reference's
``build_network(...).load_weights(path)``.  Layout written (Keras
``save_weights`` HDF5): root attrs ``layer_names`` (the weight-bearing
layers in the reference builder's ``model.layers`` order, from
``_keras_layer_orders.py``), ``backend``, ``keras_version``; per layer a
group attr ``weight_names`` and one dataset per weight.

The path map inverts the importer: :func:`map_layers` runs once on
per-weight sentinel arrays, and where each sentinel lands in the Flax tree
gives the reverse map, so exporter and importer cannot disagree.  The
checkpoint's ``state_dict`` crosses to that tree through ``convert.py``.
For the families whose convs are bias-free here the export writes zero
conv biases and the moving mean unchanged, so export -> import is bitwise
(import -> export is not: the importer folds a bias into the mean).

    python -m semantic_embeddings_torch.cli.export_keras_weights --model model.pt --out model.h5
"""

from __future__ import annotations

import argparse
import re

import numpy as np

from ._keras_layer_orders import LAYER_ORDERS
from .import_keras_weights import _fold_architecture, map_layers

#: weight names per layer kind, in Keras order (kind chars: C/c = Conv2D
#: with/without bias, B = BatchNormalization, D/d = Dense with/without
#: bias, S = bias-free SeparableConv2D — NASNet)
_WEIGHT_NAMES = {
    "C": ("kernel:0", "bias:0"),
    "c": ("kernel:0",),
    "B": ("gamma:0", "beta:0", "moving_mean:0", "moving_variance:0"),
    "D": ("kernel:0", "bias:0"),
    "d": ("kernel:0",),
    "S": ("depthwise_kernel:0", "pointwise_kernel:0"),
}


def layer_template(architecture, cls_classes=0):
    """Ordered ``[(layer_name, kind)]`` for the architecture, with the
    trainer's classification head (unnamed BatchNorm + Dense ``prob``,
    ``learn_image_embeddings.py:16-45``) appended when ``cls_classes > 0``.

    The head BN is unnamed in the reference's training script, so a fresh
    Keras session auto-names it with the next ``batch_normalization``
    counter value after the backbone's unnamed BNs."""
    if architecture not in LAYER_ORDERS:
        raise ValueError(
            f"export does not support architecture {architecture!r}; "
            f"supported: {sorted(LAYER_ORDERS)}"
        )
    template = list(LAYER_ORDERS[architecture])
    if cls_classes > 0:
        unnamed = [
            int(m.group(1) or 0)
            for n, _ in template
            for m in [re.fullmatch(r"batch_normalization(?:_(\d+))?", n)]
            if m
        ]
        bn_name = (
            "batch_normalization" if not unnamed
            else f"batch_normalization_{max(unnamed) + 1}"
        )
        template += [(bn_name, "B"), ("prob", "D")]
    return template


def _invert_importer(template, architecture, cls_classes):
    """Runs ``map_layers`` on sentinels; returns
    ``{(layer_name, weight_idx): ('params'|'batch_stats', path_tuple)}``.

    Conv-bias sentinels for fold families are zeros, so ``map_layers``
    drops them (zero bias folds to a no-op) — those weights get no mapping
    and are exported as explicit zeros."""
    fold = _fold_architecture(architecture)
    sentinels = {}
    skeleton = {}
    next_id = 1
    for name, kind in template:
        weights = []
        for idx, _ in enumerate(_WEIGHT_NAMES[kind]):
            if fold and kind in ("C", "c") and idx == 1:
                weights.append(np.zeros((1,), np.float64))
                continue
            arr = np.full((1,), float(next_id), np.float64)
            sentinels[next_id] = (name, idx)
            next_id += 1
            weights.append(arr)
        skeleton[name] = weights
    params, batch_stats, skipped = map_layers(
        skeleton, architecture, has_cls_head=cls_classes > 0
    )
    if skipped:
        raise AssertionError(
            f"{architecture}: exporter template layers not consumed by the "
            f"importer mapping: {skipped}"
        )

    reverse = {}

    def walk(tree, which, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, which, path + (key,))
            else:
                sid = int(np.asarray(val).ravel()[0])
                if sid in sentinels:
                    reverse[sentinels[sid]] = (which, path + (key,))

    walk(params, "params", ())
    walk(batch_stats, "batch_stats", ())
    missing = set(sentinels.values()) - set(reverse)
    if missing:
        raise AssertionError(
            f"{architecture}: sentinel weights lost by the importer "
            f"mapping: {sorted(missing)[:6]}"
        )
    return reverse


def export_layers(variables, architecture, cls_classes=0):
    """Returns ordered ``[(layer_name, [weight_names], [arrays])]`` for the
    checkpoint's variables (plain nested dicts with 'params' and
    'batch_stats')."""
    template = layer_template(architecture, cls_classes)
    reverse = _invert_importer(template, architecture, cls_classes)

    def leaf(which, path):
        node = variables[which]
        for part in path:
            node = node[part]
        return np.asarray(node)

    out = []
    for name, kind in template:
        wnames = [f"{name}/{w}" for w in _WEIGHT_NAMES[kind]]
        arrays = []
        for idx in range(len(wnames)):
            key = (name, idx)
            if key in reverse:
                arr = leaf(*reverse[key]).astype(np.float32)
                if kind == "S" and idx == 0:
                    # flax grouped-conv kernel (k,k,1,Cin) -> keras
                    # SeparableConv2D depthwise kernel (k,k,Cin,1)
                    arr = np.transpose(arr, (0, 1, 3, 2))
                arrays.append(arr)
            else:
                # un-folded dead conv bias: zeros of the conv's output width
                kernel = arrays[0]
                arrays.append(np.zeros((kernel.shape[-1],), np.float32))
        out.append((name, wnames, arrays))
    return out


def write_keras_h5(path, layers):
    """Writes Keras ``save_weights``-format HDF5."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [n.encode("utf8") for n, _, _ in layers]
        )
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.2.4"
        for name, wnames, arrays in layers:
            g = f.create_group(name)
            g.attrs["weight_names"] = np.array(
                [w.encode("utf8") for w in wnames]
            )
            for w, arr in zip(wnames, arrays):
                g.create_dataset(w, data=arr)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Exports a checkpoint (of the PyTorch port or the JAX package) as "
                    "a Keras .h5 weights file loadable by the reference "
                    "implementation (build_network(...).load_weights(out)).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--model", type=str, required=True,
                        help="Checkpoint (--model_dump format of either package).")
    parser.add_argument("--out", type=str, required=True,
                        help="Output .h5 path.")
    parser.add_argument("--architecture", type=str, default=None,
                        help="Override when the checkpoint lacks "
                             "architecture metadata.")
    return parser


def main(argv=None):
    from .. import convert
    from . import common

    args = build_parser().parse_args(argv)
    model, meta = common.rebuild_model_from_checkpoint(args.model, "cpu", args.architecture)
    arch = meta.get("architecture") or args.architecture
    cls_classes = getattr(model, "cls_classes", 0)
    layers = export_layers(convert.state_dict_to_flax(model), arch, cls_classes)
    write_keras_h5(args.out, layers)
    n = sum(a.size for _, _, arrs in layers for a in arrs)
    print(f"Exported {n} weights in {len(layers)} Keras layers to "
          f"{args.out} ({arch}, cls_classes={cls_classes})")
    return layers


if __name__ == "__main__":
    main()
