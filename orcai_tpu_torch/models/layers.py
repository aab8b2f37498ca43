"""Building-block layers for the CRNN detectors (inference).

Counterpart of orcai_tpu/models/layers.py. Parameters are kept in float32
in torch layouts (conv OIHW, linear (out, in), LSTM weight_ih (4U, D));
each forward casts them to the dtype of its input, as the flax layers cast
theirs to the module dtype. Convolutions use TF-style SAME padding, which
for the odd kernels and unit strides here is k // 2 on each side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(kernel_size: int) -> int:
    if kernel_size % 2 != 1:
        raise ValueError(f"SAME padding needs an odd kernel, got {kernel_size}")
    return kernel_size // 2


class FrozenBiasConv(nn.Module):
    """Dense conv with bias, stride 1, SAME padding (flax FrozenBiasConv)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int):
        super().__init__()
        self.pad = _same_pad(kernel_size)
        self.weight = nn.Parameter(
            torch.zeros(features, in_ch, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=self.pad
        )


class ConvParams(nn.Module):
    """Parameter holder matching a flax nn.Conv scope (weight [+ bias])."""

    def __init__(self, out_ch: int, in_ch: int, kernel_size: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None


class SeparableConv(nn.Module):
    """Depthwise + pointwise conv run as ONE dense conv (Keras semantics).

    Like the flax layer it composes K[o, i, h, w] = dw[i, h, w] * pw[o, i]
    in float32 (a single product per element, so K is bit-equal to the flax
    einsum) and casts K to the compute dtype.
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int):
        super().__init__()
        self.pad = _same_pad(kernel_size)
        self.depthwise = ConvParams(in_ch, 1, kernel_size, bias=False)
        self.pointwise = ConvParams(features, in_ch, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (out, in, 1, 1) * (1, in, kh, kw) -> (out, in, kh, kw)
        k = self.pointwise.weight * self.depthwise.weight.permute(1, 0, 2, 3)
        return F.conv2d(
            x, k.to(x.dtype), self.pointwise.bias.to(x.dtype), padding=self.pad
        )


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with eps 1e-3 (flax nn.BatchNorm).

    As in flax, the normalization runs in float32 and the result is cast
    back to the input dtype.
    """

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(
            x.float(), self.running_mean, self.running_var, self.weight,
            self.bias, training=False, eps=self.eps,
        )
        return y.to(x.dtype)


class LSTM(nn.Module):
    """Weights of one LSTM direction, matching a flax LSTM scope.

    Keras gate math: gate order [input, forget, cell, output], which is
    torch's i, f, g, o; the single Keras bias sits in bias_ih and bias_hh
    is zero. BiLSTM runs both directions in one call.
    """

    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(4 * units, in_features))
        self.weight_hh = nn.Parameter(torch.zeros(4 * units, units))
        self.bias_ih = nn.Parameter(torch.zeros(4 * units))
        self.bias_hh = nn.Parameter(torch.zeros(4 * units))

    def flat_weights(self, dtype: torch.dtype) -> list[torch.Tensor]:
        return [
            w.to(dtype)
            for w in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)
        ]


class BiLSTM(nn.Module):
    """Bidirectional LSTM over (B, T, D), concat merge (Keras Bidirectional
    default): (B, T, 2U), the backward direction's outputs at their
    original positions.

    Both directions run in one bidirectional torch.lstm call (cuDNN on the
    card); the submodules only hold the per-direction weights.
    """

    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.units = units
        self.fwd = LSTM(in_features, units)
        self.bwd = LSTM(in_features, units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x.new_zeros(2, x.shape[0], self.units)
        weights = self.fwd.flat_weights(x.dtype) + self.bwd.flat_weights(x.dtype)
        return torch.lstm(
            x, (h0, h0), weights, True, 1, 0.0, False, True, True
        )[0]
