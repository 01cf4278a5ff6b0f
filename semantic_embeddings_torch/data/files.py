"""File-backed image datasets: threaded host decode, augmentation on the
device (counterpart of the JAX package's ``data/files.py``).

- HOST (threads, overlapped with the device through a prefetch queue):
  JPEG decode, aspect-preserving resize (with a random zoom per image),
  optional rotation, random/center crop or reflect-pad to the fixed crop
  size -> uint8 batches, pinned in the prefetch thread where a GPU is
  present.  The native decoder (``semantic_embeddings_torch.native``) does
  all of it in C++ threads; with ``use_native = False``, or for a file that
  libjpeg refuses (counted in ``pillow_retries``), Pillow does it.
  ``read_workers`` / ``queue_size`` are the reference's CLI flags.
- DEVICE (``make_prepare``): the copy (non-blocking), float conversion,
  color distortion, mean/std normalization (+ BGR reorder), 50% horizontal
  flip and random erasing.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import parallel
from . import augment
from .base import DatasetBase, batched_indices_masked, epoch_permutation
from .cifar import to_device

DEFAULT_RANDERASE = {"sl": 0.02, "sh": 0.4, "r1": 0.3, "r2": 1.0 / 0.3}


def prefetch(iterator, size=2):
    """Runs an iterator in a background thread with a bounded queue.

    Closing the returned generator early (partial epoch consumption) signals
    the worker to stop instead of leaving it blocked on a full queue; an
    error in the worker is raised in the consumer.
    """
    q = queue.Queue(maxsize=max(size, 1))
    done = object()
    stop = threading.Event()

    def put_blocking(item):
        """Enqueue, polling the stop flag so an abandoned consumer never
        leaves the worker blocked on a full queue.  Returns False if
        stopped.  Used for items AND the final sentinel: a put_nowait
        sentinel would be dropped when the queue is full, deadlocking the
        consumer at the end of the iteration."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        error = None
        try:
            for item in iterator:
                if not put_blocking(item):
                    return
        except BaseException as exc:  # re-raised in the consumer
            error = exc
        put_blocking((done, error))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()


def _host_batch(array):
    """A uint8 batch as a tensor, pinned where a GPU is present so that the
    copy to the card does not block the host."""
    t = torch.from_numpy(array)
    return t.pin_memory() if torch.cuda.is_available() else t


class FileDataset(DatasetBase):
    """Base class for datasets whose images live as files on disk.

    Subclasses populate ``train_img_files`` / ``test_img_files`` /
    ``_train_labels`` / ``_test_labels`` / ``classes`` / ``class_indices``
    and then call :meth:`_finalize`.
    """

    #: set False to decode with Pillow instead of the native decoder
    use_native = True

    def __init__(
        self,
        root_dir,
        cropsize=(224, 224),
        default_target_size=-1,
        randzoom_range=None,
        randrot_max=0,
        distort_colors=False,
        colordistort_params=None,
        randerase_prob=0.0,
        randerase_params=None,
        color_mode="rgb",
        read_workers=8,
        queue_size=4,
    ):
        self.root_dir = root_dir
        # cropsize=None: resolved lazily to the dataset-median transformed
        # image size (see _resolved_cropsize)
        self.cropsize = None if cropsize is None else tuple(cropsize)
        self.default_target_size = default_target_size
        self.randzoom_range = randzoom_range
        self.randrot_max = randrot_max
        self.distort_colors = distort_colors
        self.colordistort_params = colordistort_params or {}
        self.randerase_prob = randerase_prob
        self.randerase_params = dict(randerase_params or DEFAULT_RANDERASE)
        self.color_mode = color_mode.lower()
        self.read_workers = read_workers
        self.queue_size = queue_size
        #: images the native decoder refused and Pillow decoded instead
        self.pillow_retries = 0
        self._retries_lock = threading.Lock()

        self.train_img_files = []
        self.test_img_files = []
        self._train_labels = []
        self._test_labels = []
        self._pool = None

    # -- metadata ------------------------------------------------------

    @property
    def labels_train(self):
        return self._train_labels

    @property
    def labels_test(self):
        return self._test_labels

    @property
    def repeats(self):
        return getattr(self, "train_repeats", 1)

    @repeats.setter
    def repeats(self, value):
        self.train_repeats = value

    def _finalize(self, mean, std):
        self._train_labels = np.asarray(self._train_labels, dtype=np.int32)
        self._test_labels = np.asarray(self._test_labels, dtype=np.int32)
        self._compute_stats(mean, std)
        print(
            f"Found {self.num_train} training and {self.num_test} validation "
            f"images from {self.num_classes} classes."
        )

    def _compute_stats(self, mean, std):
        """Stores (or computes over the training images) channel-wise RGB
        mean/std."""
        if mean is None:
            acc = np.zeros(3, dtype=np.float64)
            for fn in self.train_img_files:
                acc += np.asarray(self._decode(fn), dtype=np.float64).mean((0, 1))
            mean = acc / len(self.train_img_files)
            print(f"Channel-wise mean:               {mean}")
        self.mean = np.asarray(mean, dtype=np.float32)
        if std is None:
            acc = np.zeros(3, dtype=np.float64)
            for fn in self.train_img_files:
                img = np.asarray(self._decode(fn), dtype=np.float64)
                acc += ((img - self.mean) ** 2).mean((0, 1))
            std = np.sqrt(acc / (len(self.train_img_files) - 1))
            print(f"Channel-wise standard deviation: {std}")
        self.std = np.asarray(std, dtype=np.float32)

    # -- host decode ---------------------------------------------------

    def _decode(self, path):
        from PIL import Image

        img = Image.open(path)
        if img.mode != "RGB":
            img = img.convert("RGB")
        return img

    def _resize_target(self, img, target_size, rng, randzoom):
        """Aspect-preserving shorter-side resize with optional random zoom:
        relative (float range, a factor of the target) or absolute (int
        range, the shorter side); tuples are explicit (w, h) targets."""
        if target_size is None:
            target_size = self.default_target_size
        explicit = isinstance(target_size, (tuple, list))
        if not explicit and target_size <= 0 and not (
            randzoom and self.randzoom_range
        ):
            return img
        if not explicit and target_size <= 0:
            target_size = img.size
        if randzoom and self.randzoom_range:
            lo, hi = self.randzoom_range
            if isinstance(lo, float):
                factor = rng.uniform(lo, hi)
                if isinstance(target_size, tuple):
                    target_size = tuple(int(round(s * factor)) for s in target_size)
                else:
                    target_size = int(round(target_size * factor))
            else:
                target_size = int(rng.integers(lo, hi))
        if isinstance(target_size, int):
            w, h = img.size
            if w < h:
                target = (target_size, round(h * target_size / w))
            else:
                target = (round(w * target_size / h), target_size)
        else:
            target = tuple(target_size)
        from PIL import Image

        return img.resize(target, Image.BILINEAR)

    def _load_crop(self, path, train, rng):
        """decode -> resize(+zoom) -> rotate -> random/center crop or
        reflect-pad, to a fixed (crop_h, crop_w) uint8 array."""
        img = self._decode(path)
        img = self._resize_target(img, None, rng, randzoom=train)
        if train and self.randrot_max > 0:
            from PIL import Image

            img = img.rotate(
                rng.uniform(-self.randrot_max, self.randrot_max), Image.BILINEAR
            )
        arr = np.asarray(img, dtype=np.uint8)
        cw, ch = self._resolved_cropsize()
        h, w = arr.shape[:2]

        if h > ch:
            off = rng.integers(0, h - ch + 1) if train else (h - ch) // 2
            arr = arr[off : off + ch]
        if w > cw:
            off = rng.integers(0, w - cw + 1) if train else (w - cw) // 2
            arr = arr[:, off : off + cw]
        h, w = arr.shape[:2]
        if h < ch or w < cw:
            y_pad = rng.integers(0, ch - h + 1) if train else (ch - h) // 2
            x_pad = rng.integers(0, cw - w + 1) if train else (cw - w) // 2
            arr = np.pad(
                arr,
                ((y_pad, ch - h - y_pad), (x_pad, cw - w - x_pad), (0, 0)),
                "reflect",
            )
        return arr

    def _resolved_cropsize(self):
        """Returns (crop_width, crop_height), resolving ``cropsize=None`` to
        the DATASET-median transformed image size, once (the reference
        takes each batch's median, a shape per batch; the dataset median is
        what that noisy estimator estimates, and every batch shares one
        shape).  Sizes come from image headers with the shorter-side resize
        of ``default_target_size`` applied analytically; at most 1024
        evenly spaced files are read."""
        if self.cropsize is not None:
            return self.cropsize
        from PIL import Image

        files = list(self.train_img_files) or list(self.test_img_files)
        if not files:
            raise ValueError("cropsize=None needs images to take a median of")
        if len(files) > 1024:
            files = files[:: max(1, len(files) // 1024)][:1024]
        base = self.default_target_size
        widths, heights = [], []
        for path in files:
            with Image.open(path) as im:
                w, h = im.size
            if isinstance(base, (tuple, list)):
                w, h = base
            elif isinstance(base, int) and base > 0:
                # shorter side -> base, aspect preserved (_resize_target)
                if w < h:
                    w, h = base, round(h * base / w)
                else:
                    w, h = round(w * base / h), base
            widths.append(w)
            heights.append(h)
        self.cropsize = (int(np.median(widths)), int(np.median(heights)))
        return self.cropsize

    def _native_targets(self, n, train, rng):
        """Per-image shorter-side resize targets for the native decoder, or
        None when the configuration needs the Python path (tuple targets,
        relative zoom of the original size, rotation)."""
        if train and self.randrot_max > 0:
            return None
        base = self.default_target_size
        if isinstance(base, tuple):
            return None
        if train and self.randzoom_range is not None:
            lo, hi = self.randzoom_range
            if isinstance(lo, float):
                if not isinstance(base, int) or base <= 0:
                    return None
                return np.round(
                    base * rng.uniform(lo, hi, size=n)
                ).astype(np.int32)
            return rng.integers(lo, hi, size=n).astype(np.int32)
        return np.full(n, base if base and base > 0 else 0, dtype=np.int32)

    def _compose(self, files, train, rng, rows=None):
        """One uint8 batch (n, crop_h, crop_w, 3) of ``files``; with ``rows``
        = (start, stop) only those images, at the draws the whole batch
        takes from ``rng``."""
        n = len(files)
        seeds = rng.integers(1, 2 ** 62, size=n)
        targets = self._native_targets(n, train, rng) if self.use_native else None
        if rows is not None:
            files, seeds = files[rows[0]:rows[1]], seeds[rows[0]:rows[1]]
            targets = None if targets is None else targets[rows[0]:rows[1]]
        if self.use_native:
            if targets is not None:
                from .. import native

                cw, ch = self._resolved_cropsize()
                batch, ok = native.decode_batch(
                    files, targets, seeds, train, ch, cw,
                    n_threads=self.read_workers,
                )
                failed = np.flatnonzero(~ok)
                # non-JPEG or corrupt files: Pillow, per image, counted
                for i in failed:
                    batch[i] = self._load_crop(
                        files[i], train, np.random.default_rng(seeds[i]))
                with self._retries_lock:
                    self.pillow_retries += len(failed)
                return batch

        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.read_workers)
        arrs = list(
            self._pool.map(
                lambda fs: self._load_crop(
                    fs[0], train, np.random.default_rng(fs[1])
                ),
                zip(files, seeds),
            )
        )
        return np.stack(arrs)

    # -- batch iterators ----------------------------------------------
    # Each yields {"image": uint8 tensor (B, H, W, 3), "label": int32 array
    # [, "valid": float32 mask]} from a prefetch thread.

    def _batch(self, files, labels, train, rng, valid=None, shard=False):
        """A raw batch of ``files``; with ``shard`` only this process's rows
        are read and decoded (``rows`` says where they lie)."""
        rows, n = None, len(files)
        if shard and parallel.data_size() > 1:
            start, stop = parallel.process_slice(n)
            rows = (start, stop)
            labels = labels[start:stop]
            valid = None if valid is None else valid[start:stop]
        raw = {"image": _host_batch(self._compose(files, train, rng, rows)),
               "label": labels}
        if valid is not None:
            raw["valid"] = valid
        if rows is not None:
            raw["rows"] = rows + (n,)
        return raw

    def train_batches(self, batch_size, epoch, seed=0, shard=False):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        perm = epoch_permutation(
            self._train_labels, rng, shuffle=True,
            oversample=self.oversample, repeats=self.repeats,
        )
        n_batches = int(np.ceil(len(perm) / batch_size))
        padded = np.resize(perm, n_batches * batch_size)

        def gen():
            for b in range(n_batches):
                idx = padded[b * batch_size : (b + 1) * batch_size]
                files = [self.train_img_files[i] for i in idx]
                yield self._batch(files, self._train_labels[idx], True, rng, shard=shard)

        return prefetch(gen(), self.queue_size)

    def test_batches(self, batch_size, shard=False):
        idx_b, valid_b = batched_indices_masked(self.num_test, batch_size)
        rng = np.random.default_rng(0)

        def gen():
            for idx, valid in zip(idx_b, valid_b):
                files = [self.test_img_files[i] for i in idx]
                yield self._batch(files, self._test_labels[idx], False, rng, valid=valid,
                                  shard=shard)

        return prefetch(gen(), self.queue_size)

    def train_eval_batches(self, batch_size, augment=False, epochs=1):
        """Ordered masked batches over the training files (SVM-mode feature
        extraction); with ``augment`` the host applies the train-time
        transforms (random zoom and crops)."""
        rng = np.random.default_rng(0)

        def gen():
            for _ in range(epochs):
                idx_b, valid_b = batched_indices_masked(
                    self.num_train, batch_size
                )
                for idx, valid in zip(idx_b, valid_b):
                    files = [self.train_img_files[i] for i in idx]
                    yield {
                        "image": _host_batch(self._compose(files, augment, rng)),
                        "label": self._train_labels[idx],
                        "valid": valid,
                    }

        return prefetch(gen(), self.queue_size)

    # -- device side ---------------------------------------------------

    def draw_augment(self, b, h, w, generator):
        """The train-time draws of a batch of ``b`` (h, w) images, from
        ``generator``: color distortion (None unless ``distort_colors``),
        flips and random erasing (None at probability 0)."""
        color = (augment.draw_color_params(b, generator, **self.colordistort_params)
                 if self.distort_colors else None)
        flip = augment.draw_flips(b, generator)
        erase = None
        if self.randerase_prob > 0:
            erase = augment.draw_erasing_params(
                b, h, w, 3, generator, probability=self.randerase_prob,
                **{k: self.randerase_params[k] for k in ("sl", "sh", "r1", "r2")})
        return {"color": color, "flip": flip, "erase": erase}

    def make_prepare(self, device, augment_train=True):
        """Returns ``prepare(raw, rng, train) -> (images, labels)``: NHWC
        float32 normalized images and int64 labels on ``device``; ``rng`` is
        a ``torch.Generator`` on ``device`` from which :meth:`draw_augment`
        draws the train-time augmentation (of a process's rows of a global
        batch, ``raw["rows"]``, drawn for the whole batch and applied to
        these rows)."""
        device = torch.device(device)
        mean = torch.as_tensor(self.mean, device=device)
        std = torch.as_tensor(self.std, device=device)
        bgr = self.color_mode == "bgr"

        def prepare(raw, rng, train):
            images = raw["image"]
            if isinstance(images, torch.Tensor):
                images = images.to(device, non_blocking=True)
            else:
                images = to_device(images, device)
            images = images.float()
            labels = to_device(np.asarray(raw["label"], dtype=np.int64), device)
            draws = None
            if train and augment_train:
                b, h, w, _ = images.shape
                start, stop, n = parallel.local_rows(raw, b)
                draws = augment.rows_of(self.draw_augment(n, h, w, rng), start, stop)
                if draws["color"] is not None:
                    images = augment.distort_color_apply(images, **draws["color"])
            images = augment.normalize(images, mean, std, bgr=bgr)
            if draws is not None:
                images = augment.flip_apply(images, draws["flip"])
                if draws["erase"] is not None:
                    # in normalized space, as the reference erases
                    images = augment.erasing_apply(images, mean, std, *draws["erase"])
            return images, labels

        return prepare
