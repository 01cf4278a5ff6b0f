"""Minimal stdlib client for the serving HTTP API.

Counterpart of the JAX package's ``serving/client.py``: urllib + numpy, so
that other services can vendor it.  The npy content type is the efficient
path: one binary round trip, no JSON number parsing.

    client = ServingClient("http://localhost:8000")
    emb = client.predict(images)          # (n, H, W, C) pixels -> array
    emb = client.predict_jpeg(jpeg_bytes) # raw encoded image
    client.health(), client.meta(), client.stats()
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request

import numpy as np


class ServingError(RuntimeError):
    """The server answered with an error status; carries the code and the
    server's message."""

    def __init__(self, code, message):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code


def to_pixels(images):
    """``images`` as uint8 pixels: rounded to the nearest integer, and
    refused (ValueError) where a value lies outside [0, 255] or is not
    finite, instead of wrapping or truncating it."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return arr
    values = np.rint(arr.astype(np.float64))
    if not np.all(np.isfinite(values)) or values.min() < 0 or values.max() > 255:
        raise ValueError("pixel values must lie in [0, 255] to go over the uint8 wire")
    return values.astype(np.uint8)


class ServingClient:
    def __init__(self, base_url, timeout=60.0, retries=0, retry_backoff=0.2):
        """``retries``: extra attempts after a retryable failure: HTTP 503
        (the server's backpressure when its pending-image queue is full),
        other 5xx, and connection errors.  4xx answers are never retried
        (the request itself is bad).  ``retry_backoff``: the first sleep in
        seconds, doubled each attempt."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)

    # -- internals -----------------------------------------------------------

    def _request_once(self, path, body=None, ctype=None, accept=None):
        headers = {}
        if ctype:
            headers["Content-Type"] = ctype
        if accept:
            headers["Accept"] = accept
        req = urllib.request.Request(
            self.base_url + path, data=body, headers=headers,
            method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.headers.get("Content-Type"), resp.read()
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                message = json.loads(raw).get("error", raw.decode(errors="replace"))
            except ValueError:  # not a JSON error body
                message = raw.decode(errors="replace")
            raise ServingError(e.code, message) from None

    def _request(self, path, body=None, ctype=None, accept=None):
        delay = self.retry_backoff
        for attempt in range(self.retries + 1):
            try:
                return self._request_once(path, body, ctype, accept)
            except ServingError as e:
                if attempt >= self.retries or e.code < 500:
                    raise
            except urllib.error.URLError:
                if attempt >= self.retries:
                    raise
            time.sleep(delay)
            delay *= 2

    def _get_json(self, path):
        _, body = self._request(path)
        return json.loads(body)

    # -- API -----------------------------------------------------------------

    def health(self):
        return self._get_json("/healthz")

    def meta(self):
        return self._get_json("/v1/meta")

    def stats(self):
        return self._get_json("/v1/stats")

    def predict(self, images, normalized=False, wire_dtype=np.float32):
        """``images``: (n, H, W, C) or (H, W, C) pixel values.  Uses the
        binary npy round trip; ``normalized=True`` sends pre-normalized
        values through :meth:`predict_json` instead.  ``wire_dtype=np.uint8``
        sends pixels at a quarter of the bytes (the pairing for a
        ``--device_preproc`` server): they are rounded, and values outside
        [0, 255] raise ValueError before anything is sent."""
        if normalized:
            return np.asarray(self.predict_json(images, normalized=True),
                              dtype=np.float32)
        if np.dtype(wire_dtype) == np.uint8:
            wire = to_pixels(images)
        else:
            wire = np.asarray(images, dtype=wire_dtype)
        buf = io.BytesIO()
        np.save(buf, wire, allow_pickle=False)
        ctype, body = self._request("/v1/predict", buf.getvalue(), "application/x-npy",
                                    accept="application/x-npy")
        if ctype == "application/x-npy":
            return np.load(io.BytesIO(body), allow_pickle=False)
        # multi-output models answer in JSON whatever the Accept
        return json.loads(body)["predictions"]

    def predict_json(self, images, normalized=False):
        """JSON round trip (slower; carries the ``normalized`` flag)."""
        payload = {"instances": np.asarray(images, dtype=np.float32).tolist(),
                   "normalized": bool(normalized)}
        _, body = self._request("/v1/predict", json.dumps(payload).encode("utf-8"),
                                "application/json")
        return json.loads(body)["predictions"]

    def predict_jpeg(self, blob):
        """Raw encoded JPEG bytes; the server decodes, resizes, center-crops
        and normalizes."""
        _, body = self._request("/v1/predict", bytes(blob), "image/jpeg")
        return np.asarray(json.loads(body)["predictions"], dtype=np.float32)
