"""CLI: serve a trained model over HTTP with dynamic micro-batching.

The PyTorch counterpart of the JAX package's ``cli/serve_model.py``, with
``--device``: it serves an artifact of ``export_model`` (``torch.export``)
or a checkpoint (``--model_dump`` / ``--snapshot`` of the port's learners).
Run it as ``python -m semantic_embeddings_torch.cli.serve_model``:

    python -m semantic_embeddings_torch.cli.serve_model --artifact model.pt2 \\
        --dataset ilsvrc --warmup
    python -m semantic_embeddings_torch.cli.serve_model --checkpoint model.pt \\
        --layer l2norm --input_size 224 --dataset ilsvrc --warmup

    curl -s localhost:8000/healthz
    curl -s -X POST -H 'Content-Type: image/jpeg' \\
        --data-binary @img.jpg localhost:8000/v1/predict

The forward runs on the device in eval mode under ``torch.inference_mode()``
(bf16 under ``torch.autocast`` with ``--bf16``), through the model's own
kernels (the ImageNet ResNets' fused 3x3 conv + BN statistics); an
artifact's graph calls the same kernels through the port's custom ops.
Normalization: ``--dataset`` picks that dataset's channel statistics, or
``--mean``/``--std`` give them; JSON requests may skip it with
``"normalized": true``.  SIGTERM stops accepting, drains and exits 0.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch


def build_parser():
    from . import common

    parser = argparse.ArgumentParser(
        description="Serves a trained model over HTTP with dynamic "
                    "micro-batching.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    src = parser.add_argument_group("model source")
    src.add_argument("--artifact", type=str, default=None,
                     help="Artifact (.pt2) from export_model (reads the "
                          ".json sidecar when present).")
    src.add_argument("--checkpoint", type=str, default=None,
                     help="Model dump / snapshot to serve.")
    src.add_argument("--architecture", type=str, default=None,
                     help="Backbone architecture (checkpoints without "
                          "metadata only).")
    src.add_argument("--layer", type=str, default=None,
                     help="Feature tap (l2norm / embedding / prob / "
                          "avg_pool); checkpoint source only.")
    src.add_argument("--input_size", type=int, default=None,
                     help="Input image height/width (default: the "
                          "artifact's sidecar value, else 32).")
    src.add_argument("--input_channels", type=int, default=3)
    src.add_argument("--bf16", action="store_true", default=False,
                     help="Run the forward in bfloat16 under torch.autocast "
                          "(f32 weights); checkpoint source only: artifacts "
                          "bake their dtype at export (export_model --bf16).")
    src.add_argument("--device", type=str, default="cuda",
                     help="Device to run on (cuda, cuda:N or cpu). A CUDA "
                          "device that is not present is an error.")

    srv = parser.add_argument_group("server")
    srv.add_argument("--host", type=str, default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    srv.add_argument("--max_batch", type=int, default=256,
                     help="Largest device batch (and request size cap).")
    srv.add_argument("--batch_timeout_ms", type=float, default=2.0,
                     help="How long the batcher waits to fill a batch "
                          "after the first request arrives.")
    srv.add_argument("--request_timeout_s", type=float, default=60.0)
    srv.add_argument("--gpus", type=int, default=1,
                     help="Number of devices to serve on: a replica of the "
                          "model on each, every device call split over them "
                          "(fewer present: those that are).")
    srv.add_argument("--max_queue", type=int, default=None,
                     help="Pending-image cap; beyond it requests get HTTP "
                          "503 + Retry-After instead of queueing unbounded "
                          "(default: 16 full batches).")
    srv.add_argument("--decode_threads", type=int, default=4,
                     help="Threads of the native JPEG decoder a request uses.")
    srv.add_argument("--warmup", action="store_true", default=False,
                     help="Run every batch bucket once before accepting "
                          "traffic (cuDNN algorithm choice, kernel builds).")

    prep = parser.add_argument_group("preprocessing")
    prep.add_argument("--dataset", type=str, default=None,
                      help="Use this dataset's channel mean/std for "
                           "normalization.")
    prep.add_argument("--data_root", type=str, default=None,
                      help="Dataset root (only needed when the --dataset "
                           "statistics require reading the data).")
    prep.add_argument("--mean", type=str, default=None,
                      help="Channel mean as CSV, e.g. 125.3,123.0,113.9.")
    prep.add_argument("--std", type=str, default=None,
                      help="Channel std as CSV.")
    prep.add_argument("--target_size", type=int, default=None,
                      help="Shorter-side resize target for JPEG requests "
                           "before the center crop (default: crop size).")
    prep.add_argument("--decoder", choices=common.DECODERS, default="auto",
                      help="JPEG decoder of request bodies: the native C++ decoder "
                           "(built with g++ against libjpeg at first use; with "
                           "'native' a failed build is an error), Pillow, or 'auto': "
                           "the native decoder where it builds and loads, else Pillow.")
    prep.add_argument("--device_preproc", action="store_true", default=False,
                      help="Transfer uint8 pixels and run the mean/std "
                           "normalization on the device: a quarter of the "
                           "host-to-device bytes. Requests must carry raw "
                           "pixel values (JPEG, or integer arrays in [0, 255]).")
    return parser


def _csv_floats(text):
    return [float(v) for v in text.split(",") if v.strip()]


def build_model_fn(args, device):
    """Returns ``(forward, meta)``: ``forward`` maps normalized (B, H, W, C)
    images on ``device`` to the served output (tensors, f32)."""
    from . import common

    if bool(args.artifact) == bool(args.checkpoint):
        raise SystemExit("pass exactly one of --artifact / --checkpoint")
    if args.artifact:
        return _artifact_fn(args, device)
    from .export_model import ServingForward

    model, ckpt_meta = common.rebuild_model_from_checkpoint(
        args.checkpoint, device, args.architecture)
    # without --layer the whole output, (embedding, prob) included
    module = ServingForward(model, args.layer, torch.bfloat16 if args.bf16 else None)
    meta = {"checkpoint": os.path.abspath(args.checkpoint), "layer": args.layer,
            "compute_dtype": "bfloat16" if args.bf16 else "float32",
            "device": str(device)}
    meta.update({k: v for k, v in ckpt_meta.items()
                 if isinstance(v, (str, int, float, bool, type(None)))})
    meta["input_size"] = args.input_size or 32
    meta["input_channels"] = args.input_channels

    def forward(images):
        with torch.inference_mode():
            return module(images)

    return forward, meta


def _artifact_fn(args, device):
    """The forward of an ``export_model`` artifact, loaded with
    ``torch.export.load`` (the port's custom ops registered first) and moved
    to ``device``; its sidecar's fields in the metadata."""
    from .export_model import load_artifact

    if args.bf16:
        raise SystemExit(
            "--bf16 applies to --checkpoint serving only; artifacts bake "
            "their compute dtype at export time (export_model --bf16).")
    if args.layer is not None:
        raise SystemExit("--layer applies to --checkpoint serving only; "
                         "artifacts bake their tap at export time "
                         "(export_model --layer).")
    program, sidecar = load_artifact(args.artifact, device)
    exported_on = sidecar.get("platforms")
    if exported_on and device.type not in exported_on:
        raise SystemExit(
            f"{args.artifact} was exported for {exported_on}, not {device.type}: "
            "export it on the kind of device that serves it.")
    meta = {"artifact": os.path.abspath(args.artifact), **sidecar, "device": str(device)}
    shape = sidecar.get("input_shape", [-1, 32])
    meta["input_size"] = args.input_size or abs(shape[1]) or 32
    meta["input_channels"] = args.input_channels
    meta["fixed_batch"] = shape[0] if shape[0] > 0 else None

    def forward(images):
        with torch.inference_mode():
            return program(images)

    return forward, meta


#: Published channel statistics (the reference README's), so that serving
#: does not need the training data on disk.
PUBLISHED_STATS = {
    "cifar-100": ([129.30386353, 124.06987, 112.43356323],
                  [68.17019653, 65.39176178, 70.4180603]),
    "nab": ([125.30513277, 129.66606421, 118.45121113],
            [57.0045467, 56.70059436, 68.44430446]),
}


def resolve_stats(args):
    if args.mean or args.std:
        return (_csv_floats(args.mean) if args.mean else None,
                _csv_floats(args.std) if args.std else None)
    if args.dataset:
        from .. import data as data_mod

        name = args.dataset.lower()
        if name in PUBLISHED_STATS:
            return PUBLISHED_STATS[name]
        if name in ("cub", "cub-large"):
            return data_mod.CUB_STATS
        if name in ("ilsvrc", "imagenet") or name.endswith("-ilsvrcmean"):
            return data_mod.IMAGENET_MEAN, data_mod.IMAGENET_STD
        if name.endswith("-caffe"):
            return data_mod.CAFFE_MEAN, data_mod.CAFFE_STD
        if args.data_root:
            # the port's in-memory datasets keep their statistics on the
            # 0-255 pixel scale already
            ds = data_mod.get_data_generator(name, args.data_root)
            return list(np.asarray(ds.mean).ravel()), list(np.asarray(ds.std).ravel())
        raise SystemExit(
            f"no published stats for dataset '{args.dataset}'; pass "
            "--data_root to compute them or give --mean/--std directly")
    return None, None


def _device_fn(forward, device, mean, std, device_preproc):
    """The engine's call on ``device``: the host batch copied there (uint8
    cast and normalized there with ``device_preproc``: a quarter of the
    bytes on the wire), then ``forward``, with ``device`` current so that
    every launch goes to its streams."""
    from ..data.cifar import to_device

    on_card = (torch.cuda.device(device) if device.type == "cuda"
               else contextlib.nullcontext())
    mean = torch.as_tensor(0.0 if mean is None else mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(1.0 if std is None else std, dtype=torch.float32, device=device)

    def fn(batch):
        with on_card:
            x = to_device(batch, device)
            return forward((x.float() - mean) / std if device_preproc else x)

    return fn


def make_server(args):
    from .. import parallel
    from ..serving import BatchingEngine, Preprocessor, ServingServer
    from . import common

    device = common.resolve_device(args.device)
    common.set_float32_precision()
    # --gpus N: a replica of the model on each of N devices, every pack split
    # over them (the CPU stands in for any number of devices)
    n_dev = common.mesh_size(args.gpus, common.available_devices(device))
    devices = parallel.get_devices(n_dev, device) if n_dev > 1 else [device]
    meta = None
    mean, std = resolve_stats(args)
    fns = []
    for dev in devices:
        forward, dev_meta = build_model_fn(args, dev)
        meta = meta or dev_meta
        fns.append(_device_fn(forward, dev, mean, std, args.device_preproc))
    meta["mean"], meta["std"] = mean, std
    if n_dev > 1:
        meta["devices"] = n_dev
    engine_dtype = np.uint8 if args.device_preproc else np.float32
    if args.device_preproc:
        meta["device_preproc"] = True
    decoder = common.resolve_decoder(args.decoder)
    preproc = Preprocessor(meta["input_size"], args.input_channels, mean=mean, std=std,
                           target_size=args.target_size, device_norm=args.device_preproc,
                           decoder=decoder, n_threads=args.decode_threads)
    print(f"JPEG bodies decode with the {'native' if decoder == 'native' else 'Pillow'} "
          f"decoder (--decoder {args.decoder})", flush=True)
    # an artifact of a fixed batch takes that batch only, on each device
    fixed = meta.get("fixed_batch")
    fixed = fixed and fixed * n_dev
    engine = BatchingEngine(
        fns, (meta["input_size"], meta["input_size"], args.input_channels),
        max_batch=fixed or args.max_batch, timeout_ms=args.batch_timeout_ms,
        buckets=[fixed] if fixed else None, max_queue=args.max_queue,
        dtype=engine_dtype)
    return ServingServer(engine, preproc, meta, host=args.host, port=args.port,
                         request_timeout=args.request_timeout_s)


def main(argv=None):
    import signal
    import threading

    args = build_parser().parse_args(argv)
    server = make_server(args)
    if args.warmup:
        print(f"warming up buckets {server.engine.buckets} ...", flush=True)
        timings = server.engine.warmup()
        print(f"warmup done: {timings} s per bucket", flush=True)
    print(f"serving on http://{args.host}:{server.port}  "
          f"(max_batch {args.max_batch}, timeout {args.batch_timeout_ms} ms)",
          flush=True)
    # Graceful SIGTERM: stop accepting, drain in-flight requests, exit 0.
    # shutdown() must come from another thread than serve_forever's.
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.httpd.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    print("serving stopped", flush=True)


if __name__ == "__main__":
    main()
