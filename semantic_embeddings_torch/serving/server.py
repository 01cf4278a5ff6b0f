"""HTTP serving frontend over the batching engine.

Counterpart of the JAX package's ``serving/server.py``; stdlib
``http.server`` only.  Endpoints:

- ``GET /healthz``     -> ``{"status": "ok"}``
- ``GET /v1/meta``     -> model metadata
- ``GET /v1/stats``    -> engine counters and latency quantiles
- ``POST /v1/predict`` -> inference.  Request body:
    * ``application/json``: ``{"instances": <nested list>}``, one image
      ``(H, W, C)`` or a batch ``(n, H, W, C)`` of raw pixel values; the
      server applies the configured mean/std normalization unless
      ``"normalized": true`` is set in the payload.
    * ``application/x-npy``: a serialized numpy array, as ``instances``.
    * ``image/jpeg``: raw JPEG bytes, decoded by the native decoder
      (``native.decode_mem_batch``) or, with ``decoder="pillow"``, by
      Pillow (shorter side resized, center crop to the model input), then
      normalized.
  Response: ``{"predictions": ...}`` JSON, or ``application/x-npy`` when the
  request sets ``Accept: application/x-npy`` and the model returns one array.
  A bad request gets 400, a full queue 503 with ``Retry-After``, a failure
  of the model 500.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .engine import EngineOverloaded, _map


class PreprocessError(ValueError):
    pass


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


class Preprocessor:
    """Host-side request preprocessing: JPEG decode and normalization.

    ``decoder``: ``"native"`` decodes JPEG bodies with the native decoder
    (bilinear resize of the shorter side to ``target_size``, center crop;
    ``n_threads`` decode threads), as the JAX package's server does;
    ``"pillow"`` with Pillow (its default resampling).  ``device_norm``: the mean/std normalization runs on the device (in the
    engine's fn, ``serve_model --device_preproc``), and this side hands on
    raw uint8 pixels.  Pre-normalized arrays are refused in that mode (the
    device would normalize them again), and so is any value that is not an
    integer pixel value in [0, 255].
    """

    def __init__(self, input_size, input_channels=3, mean=None, std=None,
                 target_size=None, device_norm=False, decoder="native", n_threads=4):
        if decoder not in ("native", "pillow"):
            raise ValueError(f"decoder must be 'native' or 'pillow', not {decoder!r}")
        self.input_size = int(input_size)
        self.input_channels = int(input_channels)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)
        # shorter-side resize target before the center crop (by default the
        # crop size itself, the reference's test-time convention)
        self.target_size = int(target_size or input_size)
        self.device_norm = bool(device_norm)
        self.decoder = decoder
        self.n_threads = int(n_threads)

    def normalize(self, x):
        x = np.asarray(x, np.float32)
        if self.mean is not None:
            x = x - self.mean
        if self.std is not None:
            x = x / self.std
        return x

    def decode_jpeg(self, blob):
        """One JPEG body -> (input_size, input_size, 3) uint8 pixels."""
        if self.decoder == "native":
            from .. import native

            imgs, ok = native.decode_mem_batch(
                [blob], [self.target_size], [1], False, self.input_size,
                self.input_size, self.n_threads)
            if not ok[0]:
                raise PreprocessError("could not decode JPEG body")
            return imgs[0]
        from PIL import Image

        try:
            pil = Image.open(io.BytesIO(blob)).convert("RGB")
        except Exception as e:  # noqa: BLE001 - any decode failure is a bad body
            raise PreprocessError(f"could not decode image: {e}") from e
        w, h = pil.size
        s = self.target_size / min(w, h)
        pil = pil.resize((max(1, round(w * s)), max(1, round(h * s))))
        img = np.asarray(pil, dtype=np.uint8)
        y0 = max(0, (img.shape[0] - self.input_size) // 2)
        x0 = max(0, (img.shape[1] - self.input_size) // 2)
        return img[y0:y0 + self.input_size, x0:x0 + self.input_size]

    def from_jpeg(self, blob):
        img = self.decode_jpeg(blob)
        if self.device_norm:
            return img[None]  # uint8; the device normalizes
        return self.normalize(img[None].astype(np.float32))

    def _batch(self, arr):
        if arr.ndim == 3:  # one HWC image
            arr = arr[None]
        want = (self.input_size, self.input_size, self.input_channels)
        if arr.ndim != 4 or arr.shape[1:] != want:
            raise PreprocessError(f"bad input shape {arr.shape}; expected (n,) + {want}")
        return arr

    def from_array(self, arr, normalized=False):
        if not self.device_norm:
            arr = self._batch(np.asarray(arr, dtype=np.float32))
            return arr if normalized else self.normalize(arr)
        if normalized:
            raise PreprocessError(
                "this server normalizes on the device (--device_preproc); send "
                "raw pixel values, not pre-normalized arrays")
        arr = self._batch(np.asarray(arr))
        if arr.dtype != np.uint8:
            values = arr.astype(np.float64)
            if not (np.all(np.isfinite(values)) and np.all(values == np.rint(values))
                    and values.min() >= 0 and values.max() <= 255):
                raise PreprocessError(
                    "this server normalizes on the device (--device_preproc) and "
                    "takes raw pixels: integer values in [0, 255]")
            arr = values.astype(np.uint8)
        return arr


def _json_bytes(obj):
    return json.dumps(obj).encode("utf-8")


def make_handler(engine, preproc, meta, request_timeout=60.0):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body, ctype="application/json", headers=()):
            self.send_response(code)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj, headers=()):
            self._send(code, _json_bytes(obj), headers=headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/v1/meta":
                self._send_json(200, meta)
            elif self.path == "/v1/stats":
                self._send_json(200, engine.stats())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/predict":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type")
                         or "application/json").split(";")[0].strip()
                if ctype == "image/jpeg":
                    x = preproc.from_jpeg(body)
                elif ctype == "application/x-npy":
                    x = preproc.from_array(np.load(io.BytesIO(body), allow_pickle=False))
                else:
                    payload = json.loads(body or b"{}")
                    if "instances" not in payload:
                        raise PreprocessError('missing "instances" key')
                    x = preproc.from_array(
                        payload["instances"],
                        normalized=bool(payload.get("normalized", False)))
            except ValueError as e:  # PreprocessError, JSONDecodeError, bad npy
                self._send_json(400, {"error": str(e)})
                return

            try:
                out = engine.predict(x, timeout=request_timeout)
            except EngineOverloaded as e:  # queue full: the caller backs off
                self._send_json(503, {"error": str(e)}, headers=[("Retry-After", "1")])
                return
            except ValueError as e:  # e.g. batch > max_batch
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - model/runtime failure
                self._send_json(500, {"error": repr(e)})
                return

            leaves = _leaves(out)
            if self.headers.get("Accept") == "application/x-npy" and len(leaves) == 1:
                buf = io.BytesIO()
                np.save(buf, np.asarray(leaves[0]), allow_pickle=False)
                self._send(200, buf.getvalue(), "application/x-npy")
                return
            preds = (np.asarray(leaves[0]).tolist() if len(leaves) == 1
                     else _map(lambda a: np.asarray(a).tolist(), out))
            self._send_json(200, {"predictions": preds})

    return Handler


class _Listener(ThreadingHTTPServer):
    # Python's default listen backlog is 5: a burst of concurrent clients
    # beyond it gets TCP resets before the accept loop runs, and a batching
    # server expects bursts.
    request_queue_size = 128


class ServingServer:
    """Owns the HTTP listener and the batching engine's lifecycle."""

    def __init__(self, engine, preproc, meta, host="127.0.0.1", port=8000,
                 request_timeout=60.0):
        self.engine = engine
        self.preproc = preproc
        handler = make_handler(engine, preproc, meta, request_timeout)
        self.httpd = _Listener((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread = None

    @property
    def port(self):
        return self.httpd.server_address[1]

    def start(self):
        self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="sed-http")
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.engine.stop()

    def serve_forever(self):
        self.engine.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.stop()
