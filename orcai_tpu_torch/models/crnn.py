"""CRNN detector architectures (inference).

Counterpart of orcai_tpu/models/crnn.py: the conv-ResNet trunk that
downsamples (736, 171, 1) -> (46, 11, 36) and the ResNetLSTM head (2x
BiLSTM + dense). Submodule names follow the flax scopes, so a checkpoint
leaf trunk/block0_sep1/... maps to the state-dict key trunk.block0_sep1....
The public forward keeps the JAX layout: input (B, T, F, 1) NHWC, output
(B, T // 2**len(filters), num_labels) sigmoid probabilities in float32.
Dropout is the identity at inference and is left out; ResNet1DConv and
ResNetTCN are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from orcai_tpu_torch.models.layers import (
    BatchNorm,
    BiLSTM,
    ConvParams,
    FrozenBiasConv,
    SeparableConv,
)


def _same_pool_pads(n: int, window: int, stride: int) -> tuple[int, int]:
    """(low, high) TF SAME padding of one dim: the extra cell goes high."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax nn.max_pool(x, (3, 2), strides=(2, 2), padding="SAME") on NCHW.

    SAME pads -inf on the high side first (1 row at T=736, 1 column at
    F=171); torch's MaxPool2d pads symmetrically, so pad explicitly.
    """
    h_lo, h_hi = _same_pool_pads(x.shape[2], 3, 2)
    w_lo, w_hi = _same_pool_pads(x.shape[3], 2, 2)
    x = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=float("-inf"))
    return F.max_pool2d(x, (3, 2), stride=(2, 2))


class ResNetTrunk(nn.Module):
    """Entry conv + residual separable-conv blocks with (2, 2) downsampling."""

    def __init__(self, filters: Sequence[int], kernel_size: int, in_ch: int = 1):
        super().__init__()
        self.filters = tuple(filters)
        k = kernel_size
        self.entry_conv = FrozenBiasConv(in_ch, 16, k)
        self.entry_bn = BatchNorm(16)
        prev = 16
        for bi, size in enumerate(self.filters):
            setattr(self, f"block{bi}_sep1", SeparableConv(prev, size, k))
            setattr(self, f"block{bi}_bn1", BatchNorm(size))
            setattr(self, f"block{bi}_sep2", SeparableConv(size, size, k))
            setattr(self, f"block{bi}_bn2", BatchNorm(size))
            setattr(self, f"block{bi}_shortcut", ConvParams(size, prev, 1, bias=True))
            prev = size
        self.head_sep = SeparableConv(prev, 36, k)
        self.head_bn = BatchNorm(36)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) -> (B, 36, T / 2**n, ceil-halved F), NCHW."""
        x = F.relu(self.entry_bn(self.entry_conv(x)))
        previous = x
        for bi in range(len(self.filters)):
            y = F.relu(x)
            y = getattr(self, f"block{bi}_sep1")(y)
            y = F.relu(getattr(self, f"block{bi}_bn1")(y))
            y = getattr(self, f"block{bi}_sep2")(y)
            y = max_pool_same(getattr(self, f"block{bi}_bn2")(y))
            shortcut = getattr(self, f"block{bi}_shortcut")
            # 1x1 stride-2 SAME conv: no padding at any size
            x = y + F.conv2d(
                previous, shortcut.weight.to(x.dtype), shortcut.bias.to(x.dtype),
                stride=2,
            )
            previous = x
        return F.relu(self.head_bn(self.head_sep(x)))


class ResNetLSTM(nn.Module):
    """Conv-ResNet trunk + 2x BiLSTM + dense head (reference production arch).

    `dtype` is the compute dtype (float32 or bfloat16); parameters stay
    float32 and the logits are cast to float32 before the sigmoid.
    """

    def __init__(
        self,
        num_labels: int,
        filters: Sequence[int] = (30, 40, 50, 60),
        kernel_size: int = 3,
        lstm_units: int = 128,
        n_freq_out: int = 11,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_labels = num_labels
        self.dtype = dtype
        self.trunk = ResNetTrunk(filters, kernel_size)
        self.bilstm1 = BiLSTM(n_freq_out * 36, lstm_units)
        self.bilstm2 = BiLSTM(2 * lstm_units, lstm_units)
        self.dense = nn.Linear(2 * lstm_units, 128)
        self.dense_bn = BatchNorm(128)
        self.out = nn.Linear(128, num_labels)

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        x = self.trunk(x.permute(0, 3, 1, 2).to(self.dtype))
        b, c, t, f = x.shape
        # (B, 46, 11*36) frequency-major, as the NHWC reshape in flax
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        x = self.bilstm2(self.bilstm1(x))
        x = F.relu(F.linear(x, self.dense.weight.to(x.dtype),
                            self.dense.bias.to(x.dtype)))
        x = self.dense_bn(x.transpose(1, 2)).transpose(1, 2)
        logits = F.linear(x, self.out.weight.to(x.dtype), self.out.bias.to(x.dtype))
        logits = logits.float()
        return logits if return_logits else torch.sigmoid(logits)


def _freq_after_trunk(n_freq: int, n_blocks: int) -> int:
    for _ in range(n_blocks):
        n_freq = -(-n_freq // 2)
    return n_freq


def build_model(
    orcai_parameter: dict,
    input_shape: Sequence[int] = (736, 171, 1),
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Instantiate an architecture from the orcai parameter schema."""
    arch = orcai_parameter["architecture"]
    if arch != "ResNetLSTM":
        raise ValueError(
            f"architecture {arch!r} is not ported yet (only ResNetLSTM is)"
        )
    mp = orcai_parameter["model"]
    return ResNetLSTM(
        num_labels=len(orcai_parameter["calls"]),
        filters=tuple(mp["filters"]),
        kernel_size=mp["kernel_size"],
        lstm_units=mp["lstm_units"],
        n_freq_out=_freq_after_trunk(input_shape[1], len(mp["filters"])),
        dtype=dtype,
    )
