"""Plain-11 architecture (Barz & Denzler, ICPRAI 2018), ``simple``.

Counterpart of the JAX package's ``models/plainnet.py``: a VGG-ish stack
described by a spec list (ints = 3x3 conv, ``'ap'``/``'mp'`` = 2x2 pooling,
``'gap'`` = global average pooling, ``'fcN'`` = dense), each conv or dense
followed by the activation and then BatchNorm (conv -> act -> BN), and a
final dense layer named ``top``.  Layer ``i`` of the spec (counted from 1,
pools included) is named ``conv{i}``/``fc{i}`` with ``bn{i}``, as in the
Flax tree.  (Pools are 2x2: no caller sets the JAX module's
``pool_size``, so it is not ported.)
"""

from __future__ import annotations

from typing import Any, Sequence

from torch import nn

from .layers import (
    KerasBatchNorm,
    activation_fn,
    avg_pool,
    conv,
    dense,
    flatten_nhwc,
    global_avg_pool,
    max_pool,
    top_output,
)

DEFAULT_FILTERS = (64, 64, "ap", 128, 128, 128, "ap", 256, 256, 256, "ap", 512, "gap", "fc512")


class PlainNet(nn.Module):
    """Takes NHWC images; returns (B, output_dim).  ``input_size`` is only
    needed when a dense layer follows a spatial map without global pooling
    (its input width is then the flattened map's)."""

    def __init__(self, output_dim, filters: Sequence[Any] = DEFAULT_FILTERS,
                 activation="relu", final_activation=None,
                 input_channels=3, input_size=32, generator=None):
        super().__init__()
        self.filters = tuple(filters)
        self.activation = activation
        self.final_activation = final_activation
        channels, size, flat = input_channels, input_size, None
        for i, f in enumerate(self.filters, start=1):
            if f in ("mp", "ap"):
                size //= 2
            elif f == "gap":
                flat = channels
            elif isinstance(f, str) and f.startswith("fc"):
                width = int(f[2:])
                self.add_module(f"fc{i}", dense(
                    flat if flat is not None else channels * size * size, width, generator))
                self.add_module(f"bn{i}", KerasBatchNorm(width))
                flat = width
            else:
                self.add_module(f"conv{i}", conv(channels, int(f), 3, 1, True, generator))
                self.add_module(f"bn{i}", KerasBatchNorm(int(f)))
                channels = int(f)
        width = flat if flat is not None else channels * size * size
        self.top = dense(width, output_dim, generator)
        self.out_features = output_dim

    def forward(self, x, taps=None):
        """``taps``: a dict that, when given, also receives the pooled
        features as ``avg_pool`` and the top's output as ``embedding`` (or
        ``prob`` under a softmax top)."""
        act = activation_fn(self.activation)
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        for i, f in enumerate(self.filters, start=1):
            if f == "mp":
                x = max_pool(x, 2)
            elif f == "ap":
                x = avg_pool(x, 2)
            elif f == "gap":
                x = global_avg_pool(x)
                if taps is not None:
                    taps["avg_pool"] = x
            elif isinstance(f, str) and f.startswith("fc"):
                x = act(getattr(self, f"fc{i}")(flatten_nhwc(x)))
                x = getattr(self, f"bn{i}")(x)
            else:
                x = getattr(self, f"bn{i}")(act(getattr(self, f"conv{i}")(x)))
        return top_output(self.top(flatten_nhwc(x)), self.final_activation, taps)
