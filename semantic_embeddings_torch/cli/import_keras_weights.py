"""CLI: import the reference's Keras ``.h5`` weights into a checkpoint of the
port (the counterpart of the JAX package's ``cli/import_keras_weights.py``).

The reference publishes trained Keras models (its ``README.md:327-338``);
this tool reads the Keras HDF5 weight layout (full-model saves with a
``model_weights`` group, and ``save_weights`` files).  :func:`map_layers` is
the port's own copy of the JAX importer's numpy mapping, which names each
weight by its Flax path (``params`` / ``batch_stats``):

- ``simple``: ``conv{i}/bn{i}/fc{i}`` -> same names, the final dense
  (``embedding``/``prob``) -> ``top``;
- ``resnet-32/110/-fc/-wfc``: ``conv0/bn0``, ``res{s}-{b}x|y|z`` /
  ``bn{s}-{b}x|y|z`` -> ``stage{s}_block{b}/conv_a|conv_b|conv_sc`` (+BNs);
- ``resnet-50`` (keras.applications v1 names) and ``resnet-101/152``
  (``keras_applications.resnet`` names) -> ``stage{S-1}_block{N}/...``;
- ``wrn-28-10``, the PyramidNets and DenseNets, whose inner layers are
  unnamed in the reference: by the order of the h5 layer list;
- ``nasnet-a``: by name (SeparableConv2D depthwise kernels transposed);
- the trainer's classification head: ``prob`` -> ``cls_top``, its
  BatchNorm -> ``cls_bn``;
- ``rn18``-``rn200`` (keras-resnet): refused, their naming could not be
  verified.

Families whose convs are bias-free here fold a Keras conv bias into the
following BatchNorm's moving mean.  ``convert.flax_to_state_dict``
turns the mapped leaves into ``state_dict`` entries of the port's model
(shapes checked), and the result is written as a port model dump
(``torch.save``) with the metadata ``rebuild_model_from_checkpoint`` reads,
plus ``imported_from``.  Leaves the file lacks keep the model's initial
values.

    python -m semantic_embeddings_torch.cli.import_keras_weights --h5 model.h5 \
        --architecture resnet-110-wfc --embed_dim 100 [--cls_classes 100] --out model.pt
"""

from __future__ import annotations

import argparse
import re

import numpy as np


def read_keras_h5(path):
    """Returns ``{layer_name: [arrays...]}`` in Keras weight order."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        group = f["model_weights"] if "model_weights" in f else f
        raw_names = group.attrs.get("layer_names")
        if raw_names is None:
            # Keras always writes layer_names in creation order; without it
            # h5py iterates alphabetically (conv2d_10 before conv2d_2),
            # which would scramble the ORDER-based maps for the
            # unnamed-layer families. Natural-sort the numeric suffixes and
            # warn — creation order cannot be fully recovered.
            import re
            import warnings

            warnings.warn(
                f"{path} has no layer_names attribute; falling back to "
                "natural-sorted group keys. Order-based imports "
                "(wrn/pyramidnet/densenet) may be unreliable for files not "
                "written by Keras.", RuntimeWarning,
            )
            def natkey(name):
                return [int(t) if t.isdigit() else t
                        for t in re.split(r"(\d+)", name)]

            raw_names = sorted(group.keys(), key=natkey)
        layer_names = [
            n.decode() if isinstance(n, bytes) else n for n in raw_names
        ]
        for lname in layer_names:
            g = group[lname]
            weight_names = [
                n.decode() if isinstance(n, bytes) else n
                for n in g.attrs.get("weight_names", [])
            ]
            if not weight_names:
                continue
            out[lname] = [np.array(g[w]) for w in weight_names]
    return out


def _assign(tree, path, leaf_name, value):
    node = tree
    for part in path:
        node = node.setdefault(part, {})
    node[leaf_name] = value


#: conv layer name -> the BatchNorm that consumes its output, for the
#: families whose convs are bias-free in this framework (every conv feeds a
#: BN, so the Keras bias is functionally dead — BN subtracts the batch mean
#: and the loss is exactly invariant to it).  An imported bias ``b`` is
#: *folded* into the following BN's moving mean as ``mean - b``: the
#: reference's moving mean was estimated over conv outputs that INCLUDED
#: ``b``, while our bias-free conv output is exactly ``b`` lower, so
#: ``mean - b`` is the matching statistic — identical normalized output at
#: inference, and training-mode batch stats never see the difference.
_CONV_TO_BN = {"conv0": "bn0", "conv_a": "bn_a", "conv_b": "bn_b",
               "conv_c": "bn_c", "conv_sc": "bn_sc"}


def _fold_architecture(architecture):
    """Families whose convs are bias-free here (SmallResNet incl. -selu,
    ImageNet ResNets, PyramidNet).  WRN/DenseNet/NASNet reference models are
    already bias-free; PlainNet (``simple``) keeps live biases
    (conv -> activation -> BN there)."""
    arch = architecture.lower().removesuffix("-selu")
    return arch.startswith(("resnet-", "rn", "pyramidnet-"))


def _put_conv(params, path, weights, bias_folds=None):
    _assign(params, path, "kernel", weights[0])
    if len(weights) <= 1:
        return
    leaf = path[-1]
    if bias_folds is not None and leaf in _CONV_TO_BN:
        bn_path = tuple(path[:-1]) + (_CONV_TO_BN[leaf],)
        bias_folds[bn_path] = np.asarray(weights[1])
    else:
        _assign(params, path, "bias", weights[1])


def _put_bn(params, batch_stats, path, weights):
    gamma, beta, mean, var = weights
    bn_path = list(path) + ["BatchNorm_0"]
    _assign(params, bn_path, "scale", gamma)
    _assign(params, bn_path, "bias", beta)
    _assign(batch_stats, bn_path, "mean", mean)
    _assign(batch_stats, bn_path, "var", var)


def _wrn_order(n_blocks=4):
    """(conv paths, bn paths) in Keras layer-creation order for the
    reference WRN (``wide_residual_network.py:8-101``): all inner layers are
    unnamed there, so the import maps by order."""
    convs, bns = ["conv0"], ["bn0"]
    for g in range(3):
        convs += [f"g{g}_expand_a", f"g{g}_expand_b", f"g{g}_skip"]
        bns += [f"g{g}_expand_bn"]
        for b in range(n_blocks - 1):
            convs += [f"g{g}_b{b}_conv_a", f"g{g}_b{b}_conv_b"]
            bns += [f"g{g}_b{b}_bn_a", f"g{g}_b{b}_bn_b"]
        bns += [f"g{g}_bn_out"]
    return convs, bns


def _pyramidnet_order(depth, bottleneck):
    """Unnamed-layer order for the reference PyramidNet
    (``cifar_pyramidnet.py:90-110,146-167``; conv0/bn0/bn4 are named)."""
    n = (depth - 2) // (9 if bottleneck else 6)
    convs, bns = [], []
    for s in range(1, 4):
        for b in range(1, n + 1):
            p = f"stage{s}_block{b}"
            bns += [f"{p}/bn_in", f"{p}/bn_a", f"{p}/bn_b"]
            convs += [f"{p}/conv_a", f"{p}/conv_b"]
            if bottleneck:
                convs += [f"{p}/conv_c"]
                bns += [f"{p}/bn_c"]
    return convs, bns


def _densenet_order(depth, bottleneck, nb_dense_block=3):
    """Unnamed-layer order for the reference vendored DenseNet
    (``models/DenseNet/densenet.py:451-534,562-661``)."""
    count = (depth - 4) // 3
    if bottleneck:
        count //= 2
    convs, bns = ["conv_init"], []
    for blk in range(nb_dense_block):
        for i in range(count):
            p = f"b{blk}_l{i}"
            bns += [f"{p}_bn"]
            if bottleneck:
                convs += [f"{p}_neck"]
                bns += [f"{p}_neck_bn"]
            convs += [f"{p}_grow"]
        if blk != nb_dense_block - 1:
            bns += [f"b{blk}_trans_bn"]
            convs += [f"b{blk}_trans"]
    bns += ["bn_final"]
    return convs, bns


#: keras NASNet layer-name patterns (tf_keras/keras_applications nasnet.py;
#: block ids: stem_1, stem_2, 0..n-1, reduce_n, n+1..2n, reduce_2n,
#: 2n+1..3n for num_blocks=n). Our module names are ``cell_{block_id}``.
_NASNET_SEP = re.compile(
    r"separable_conv_([12])_(?:(bn)_)?(?:normal|reduction)_"
    r"(left\d|right\d)_(.+)")
_NASNET_CELL_CONV = re.compile(r"(?:normal|reduction)_(conv|bn)_1_(.+)")
_NASNET_ADJUST = re.compile(r"adjust_(conv_1|conv_2|conv_projection|bn)_(.+)")


def _map_nasnet_layer(name, weights, params, batch_stats, layers, bpath):
    """Maps one keras NASNet layer by name; returns True when consumed."""
    m = _NASNET_SEP.fullmatch(name)
    if m:
        rep, is_bn, sub, block = m.groups()
        r = int(rep) - 1
        cell = bpath(f"cell_{block}", sub)
        if is_bn:
            _put_bn(params, batch_stats, cell + [f"bn{r}"], weights)
        else:
            dw, pw = weights[0], weights[1]
            # keras SeparableConv2D depthwise kernel (k,k,Cin,1) ->
            # flax grouped-conv kernel (k,k,1,Cin).  (ndim guard: the
            # exporter's sentinel inversion feeds 1-D placeholders.)
            if dw.ndim == 4:
                dw = np.transpose(dw, (0, 1, 3, 2))
            _assign(params, cell + [f"dw{r}"], "kernel", dw)
            _assign(params, cell + [f"pw{r}"], "kernel", pw)
        return True
    m = _NASNET_CELL_CONV.fullmatch(name)
    if m:
        kind, block = m.groups()
        path = bpath(f"cell_{block}", "conv_1")
        if kind == "conv":
            _put_conv(params, path + ["conv"], weights)
        else:
            _put_bn(params, batch_stats, path + ["bn"], weights)
        return True
    m = _NASNET_ADJUST.fullmatch(name)
    if m:
        which, block = m.groups()
        adjust = bpath(f"cell_{block}", "adjust")
        if which == "conv_projection":
            _put_conv(params, adjust + ["squeeze", "conv"], weights)
        elif which in ("conv_1", "conv_2"):
            _put_conv(params, adjust + ["factorize", which], weights)
        else:  # the adjust BN — its submodule depends on which path exists
            sub = ("factorize" if f"adjust_conv_1_{block}" in layers
                   else "squeeze")
            _put_bn(params, batch_stats, adjust + [sub, "bn"], weights)
        return True
    if name == "stem_conv1":
        _put_conv(params, bpath("stem_conv"), weights)
        return True
    if name == "stem_bn1":
        _put_bn(params, batch_stats, bpath("stem_bn"), weights)
        return True
    return False


_ORDERED_FAMILIES = {
    "wrn-28-10": lambda: _wrn_order(4),
    "pyramidnet-272-200": lambda: _pyramidnet_order(272, True),
    "pyramidnet-110-270": lambda: _pyramidnet_order(110, False),
    "densenet-100-12": lambda: _densenet_order(100, False),
    "densenet-100-24": lambda: _densenet_order(100, False),
    "densenet-bc-190-40": lambda: _densenet_order(190, True),
}


def map_layers(layers, architecture, has_cls_head=False, backbone_key="backbone"):
    """Maps Keras layer weights into (params, batch_stats) nested dicts.

    For bias-free-conv families (see ``_fold_architecture``), Keras conv
    biases are folded into the following BN's moving mean instead of being
    assigned (exactly equivalent; see ``_CONV_TO_BN``)."""
    if re.fullmatch(r"rn(18|34|50|101|152|200)(-selu)?", architecture):
        raise ValueError(
            f"h5 import for {architecture!r} is NOT COVERED: the reference "
            "builds this family from keras-resnet "
            "(the original's utils.py:245-264), which is not installable "
            "in this environment, so its h5 layer naming/order could not "
            "be oracle-verified. Use the keras-applications family "
            "(resnet-50/101/152) for verified h5 interop; rn* models "
            "still build and train from scratch."
        )
    params, batch_stats = {}, {}
    bias_folds = {} if _fold_architecture(architecture) else None

    def bpath(*parts):
        return ([backbone_key] if backbone_key else []) + list(parts)

    consumed = set()

    def take(name):
        consumed.add(name)
        return layers[name]

    if architecture in _ORDERED_FAMILIES:
        # These reference models leave their inner layers unnamed (Keras
        # auto-names conv2d_*/batch_normalization_*), so map them by their
        # order in the h5 layer list, which records creation order.
        conv_paths, bn_paths = _ORDERED_FAMILIES[architecture]()
        conv_names = [n for n in layers
                      if re.fullmatch(r"conv2d(_\d+)?", n)]
        bn_names = [n for n in layers
                    if re.fullmatch(r"batch_normalization(_\d+)?", n)]
        dense_names = [n for n in layers if re.fullmatch(r"dense(_\d+)?", n)]
        if len(conv_names) != len(conv_paths):
            raise ValueError(
                f"{architecture}: expected {len(conv_paths)} unnamed convs, "
                f"h5 has {len(conv_names)}"
            )
        expect_bns = len(bn_paths) + (1 if has_cls_head else 0)
        if len(bn_names) != expect_bns:
            raise ValueError(
                f"{architecture}: expected {expect_bns} unnamed BNs "
                f"(incl. cls head: {has_cls_head}), h5 has {len(bn_names)}"
            )
        for cname, path in zip(conv_names, conv_paths):
            _put_conv(params, bpath(*path.split("/")), take(cname),
                      bias_folds)
        for bname, path in zip(bn_names, bn_paths):
            _put_bn(params, batch_stats, bpath(*path.split("/")), take(bname))
        if has_cls_head:
            _put_bn(params, batch_stats, ["cls_bn"],
                    take(bn_names[len(bn_paths)]))
        # The DenseNet top Dense is unnamed too (densenet.py:660); WRN /
        # PyramidNet name theirs embedding/prob (handled below).
        if dense_names:
            _put_conv(params, bpath("top"), take(dense_names[0]))

    for name in list(layers.keys()):
        if name in consumed:
            continue
        if architecture == "nasnet-a" and _map_nasnet_layer(
                name, layers[name], params, batch_stats, layers, bpath):
            consumed.add(name)
            continue
        m_small_conv = re.fullmatch(r"res(\d+)-(\d+)([xyz])", name)
        m_small_bn = re.fullmatch(r"bn(\d+)-(\d+)([xyz])", name)
        m_rn50_conv = re.fullmatch(r"res(\d)([a-z])_branch(2a|2b|2c|1)", name)
        m_rn50_bn = re.fullmatch(r"bn(\d)([a-z])_branch(2a|2b|2c|1)", name)
        # keras_applications.resnet (resnet_common) names, used by the
        # reference's resnet-101/152 builders: conv{S}_block{N}_{i}_{conv,bn}
        m_rncommon = re.fullmatch(r"conv(\d)_block(\d+)_([0123])_(conv|bn)",
                                  name)
        is_rncommon = architecture in ("resnet-101", "resnet-152")

        if is_rncommon and m_rncommon:
            stage, block, idx, kind = m_rncommon.groups()
            sub = {"1": "_a", "2": "_b", "3": "_c", "0": "_sc"}[idx]
            path = bpath(f"stage{int(stage) - 1}_block{int(block)}",
                         ("conv" if kind == "conv" else "bn") + sub)
            if kind == "conv":
                _put_conv(params, path, take(name), bias_folds)
            else:
                _put_bn(params, batch_stats, path, take(name))
        elif is_rncommon and name == "conv1_conv":
            _put_conv(params, bpath("conv0"), take(name), bias_folds)
        elif is_rncommon and name == "conv1_bn":
            _put_bn(params, batch_stats, bpath("bn0"), take(name))
        elif architecture.startswith("resnet-") and m_small_conv:
            s, b, which = m_small_conv.groups()
            sub = {"x": "conv_a", "y": "conv_b", "z": "conv_sc"}[which]
            _put_conv(params, bpath(f"stage{s}_block{b}", sub), take(name),
                      bias_folds)
        elif architecture.startswith("resnet-") and m_small_bn:
            s, b, which = m_small_bn.groups()
            sub = {"x": "bn_a", "y": "bn_b", "z": "bn_sc"}[which]
            _put_bn(params, batch_stats,
                    bpath(f"stage{s}_block{b}", sub), take(name))
        elif architecture == "resnet-50" and m_rn50_conv:
            stage, letter, branch = m_rn50_conv.groups()
            block = ord(letter) - ord("a") + 1
            sub = {"2a": "conv_a", "2b": "conv_b", "2c": "conv_c",
                   "1": "conv_sc"}[branch]
            _put_conv(
                params,
                bpath(f"stage{int(stage) - 1}_block{block}", sub), take(name),
                bias_folds=bias_folds,
            )
        elif architecture == "resnet-50" and m_rn50_bn:
            stage, letter, branch = m_rn50_bn.groups()
            block = ord(letter) - ord("a") + 1
            sub = {"2a": "bn_a", "2b": "bn_b", "2c": "bn_c",
                   "1": "bn_sc"}[branch]
            _put_bn(
                params, batch_stats,
                bpath(f"stage{int(stage) - 1}_block{block}", sub), take(name),
            )
        elif name in ("conv0",) or (architecture == "resnet-50" and name == "conv1"):
            _put_conv(params, bpath("conv0"), take(name), bias_folds)
        elif name in ("bn0",) or (architecture == "resnet-50" and name == "bn_conv1"):
            _put_bn(params, batch_stats, bpath("bn0"), take(name))
        elif name == "bn4" and architecture.startswith("pyramidnet"):
            # the reference's named final BN (cifar_pyramidnet.py:156)
            _put_bn(params, batch_stats, bpath("bn_final"), take(name))
        elif name in ("embedding",):
            _put_conv(params, bpath("top"), take(name))
        elif name == "prob":
            if has_cls_head:
                _put_conv(params, ["cls_top"], take(name))
            else:
                _put_conv(params, bpath("top"), take(name))
        elif re.fullmatch(r"(conv|bn|fc)\d+", name) and architecture == "simple":
            kind = re.match(r"[a-z]+", name).group()
            if kind == "bn":
                _put_bn(params, batch_stats, bpath(name), take(name))
            else:
                _put_conv(params, bpath(name), take(name))
        elif re.fullmatch(r"batch_normalization(_\d+)?", name) and has_cls_head:
            _put_bn(params, batch_stats, ["cls_bn"], take(name))

    for bn_path, bias in (bias_folds or {}).items():
        if not np.any(bias):
            continue  # zero bias folds to a no-op; the BN need not be present
        node = batch_stats
        try:
            for part in list(bn_path) + ["BatchNorm_0"]:
                node = node[part]
            node["mean"] = node["mean"] - bias
        except KeyError:
            raise ValueError(
                f"nonzero conv bias for {'/'.join(bn_path)} cannot be "
                f"folded: that BatchNorm was not found in the h5 file"
            ) from None

    skipped = sorted(set(layers) - consumed)
    return params, batch_stats, skipped


def build_parser():
    parser = argparse.ArgumentParser(
        description="Imports reference Keras .h5 weights into a checkpoint of the "
                    "PyTorch port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--h5", type=str, required=True,
                        help="Keras model or weights HDF5 file.")
    parser.add_argument("--architecture", type=str, required=True)
    parser.add_argument("--embed_dim", type=int, required=True,
                        help="Embedding dimensionality the model was "
                             "trained with.")
    parser.add_argument("--loss", type=str, default="inv_corr")
    parser.add_argument("--cls_classes", type=int, default=0,
                        help="Classification-head width (0: no head).")
    parser.add_argument("--out", type=str, required=True,
                        help="Output checkpoint path (model dump format).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device the model is built on before it is saved "
                             "(cuda, cuda:N or cpu). A CUDA device that is not "
                             "present is an error.")
    return parser


def import_layers(layers, architecture, embed_dim, loss="inv_corr", cls_classes=0,
                  device="cpu"):
    """The port's embedding model (on ``device``) with the Keras ``layers``
    (``{layer: [arrays]}``, as :func:`read_keras_h5` returns them) mapped
    into it; returns ``(model, mapped leaves, skipped layer names)``."""
    from .. import convert
    from . import common

    params, batch_stats, skipped = map_layers(
        layers, architecture, has_cls_head=cls_classes > 0)
    model, _ = common.build_embedding_model(embed_dim, architecture, loss, cls_classes)
    variables = {"params": params, "batch_stats": batch_stats}
    mapped = convert.flax_to_state_dict(variables, model, complete=False)
    model.load_state_dict(mapped, strict=False)
    return model.to(device), mapped, skipped


def main(argv=None):
    from ..train.state import new_train_state, save_checkpoint
    from . import common

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    layers = read_keras_h5(args.h5)
    model, mapped, skipped = import_layers(
        layers, args.architecture, args.embed_dim, args.loss, args.cls_classes, device)
    if skipped:
        print(f"Skipped unmapped layers: {skipped}")
    save_checkpoint(args.out, new_train_state(model), {
        "architecture": args.architecture,
        "embed_dim": args.embed_dim,
        "loss": args.loss,
        "cls_classes": args.cls_classes,
        "imported_from": args.h5,
    })
    n = sum(t.numel() for t in mapped.values())
    print(f"Imported {n} parameters into {args.out}")
    return model


if __name__ == "__main__":
    main()
