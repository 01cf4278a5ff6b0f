"""ctypes bindings for the native (C++) JPEG decoder of the file datasets.

The port's copy of the JAX package's ``native/`` (it imports nothing of
that package).  ``sed_decode.cpp`` is compiled with g++ against the system
libjpeg at first use into ``build/native/<hash>/libsed_decode.so`` at the
repository root, keyed by a hash of the source and the flags, with the JAX
loader's flags exactly (``-O3 -shared -fPIC ... -ljpeg -lpthread``, no
``-march=native``), so the two builds' pixels are bitwise equal on one host.

Unlike the JAX loader, a failed build raises with the compiler's output: it
does not fall back to Pillow.  Only a dataset made with ``use_native =
False`` decodes with Pillow.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sed_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
#: g++ flags around the source and the output, as the JAX package's loader has them
FLAGS = ["-O3", "-shared", "-fPIC"]
LIBS = ["-ljpeg", "-lpthread"]

_loaded: dict[Path, ctypes.CDLL] = {}

_DECODE_TAIL = [
    ctypes.POINTER(ctypes.c_int),     # target_sizes
    ctypes.POINTER(ctypes.c_uint64),  # seeds
    ctypes.c_int,                     # random_crop
    ctypes.c_int,                     # crop_h
    ctypes.c_int,                     # crop_w
    ctypes.c_int,                     # n_threads
    ctypes.POINTER(ctypes.c_uint8),   # out
    ctypes.POINTER(ctypes.c_uint8),   # ok flags
]


def library_path(source=SOURCE, build_dir=BUILD_DIR):
    digest = hashlib.sha256(
        Path(source).read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return Path(build_dir) / digest / "libsed_decode.so"


def build(source=SOURCE, build_dir=BUILD_DIR):
    """Compiles ``source`` unless a library of it exists; returns its path.
    Raises ``RuntimeError`` with g++'s output when the compile fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(source), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ at all
        raise RuntimeError(f"cannot run {cmd[0]} to build the JPEG decoder: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building the JPEG decoder:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def loader(source=SOURCE, build_dir=BUILD_DIR):
    """The loaded shared library, built first if needed.  Raises
    ``RuntimeError`` when it cannot be built or loaded."""
    path = build(source, build_dir)
    lib = _loaded.get(path)
    if lib is None:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:  # e.g. built on a host with another libjpeg
            raise RuntimeError(f"cannot load the JPEG decoder {path}: {e}") from e
        lib.sed_decode_batch.restype = ctypes.c_int
        lib.sed_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,                     # n
            *_DECODE_TAIL,
        ]
        lib.sed_decode_mem_batch.restype = ctypes.c_int
        lib.sed_decode_mem_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # buffers
            ctypes.POINTER(ctypes.c_uint64),  # lengths
            ctypes.c_int,                     # n
            *_DECODE_TAIL,
        ]
        _loaded[path] = lib
    return lib


def _tail(n, target_sizes, seeds, random_crop, crop_h, crop_w, n_threads):
    """(out, ok, arrays to keep alive, the C arguments after n)."""
    if len(target_sizes) != n or len(seeds) != n:
        raise ValueError(f"{n} images but {len(target_sizes)} targets and "
                         f"{len(seeds)} seeds")
    if crop_h <= 0 or crop_w <= 0:
        raise ValueError(f"bad crop size ({crop_h}, {crop_w})")
    out = np.empty((n, crop_h, crop_w, 3), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    ts = np.ascontiguousarray(np.asarray(target_sizes, dtype=np.int32))
    sd = np.ascontiguousarray(np.asarray(seeds, dtype=np.uint64))
    args = [
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        sd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(bool(random_crop)), int(crop_h), int(crop_w), int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ]
    return out, ok, (ts, sd), args


def decode_batch(paths, target_sizes, seeds, random_crop, crop_h, crop_w,
                 n_threads=8):
    """Decodes a batch of JPEG files into a (n, crop_h, crop_w, 3) uint8 array.

    ``target_sizes``: each image's shorter-side resize target (<= 0: none);
    ``seeds``: each image's crop seed; ``random_crop``: random (training) or
    center crops, reflect-padded where the image is smaller than the crop.
    Returns ``(batch, ok)``; ``ok`` marks each image's success, and a failed
    image (non-JPEG, corrupt) is left for the caller to fill in.
    """
    lib = loader()
    n = len(paths)
    out, ok, keep, tail = _tail(n, target_sizes, seeds, random_crop, crop_h,
                                crop_w, n_threads)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.sed_decode_batch(c_paths, n, *tail)
    del keep
    return out, ok.astype(bool)


def decode_mem_batch(blobs, target_sizes, seeds, random_crop, crop_h, crop_w,
                     n_threads=8):
    """:func:`decode_batch` of in-memory JPEG byte strings (request bodies)."""
    lib = loader()
    n = len(blobs)
    out, ok, keep, tail = _tail(n, target_sizes, seeds, random_crop, crop_h,
                                crop_w, n_threads)
    blobs = [bytes(b) for b in blobs]  # held until the call returns
    bufs = (ctypes.c_void_p * n)(
        *[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p) for b in blobs])
    lens = np.ascontiguousarray(np.asarray([len(b) for b in blobs], dtype=np.uint64))
    lib.sed_decode_mem_batch(
        bufs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, *tail)
    del keep
    return out, ok.astype(bool)
