"""CRNN detector architectures, inference and training.

Counterpart of orcai_tpu/models/crnn.py: the conv-ResNet trunk that
downsamples (736, 171, 1) -> (46, 11, 36), topped with 2x BiLSTM + dense
(ResNetLSTM, the production model), a frequency mean + wide Conv1D
(ResNet1DConv) or a dilated temporal-conv stack + dense (ResNetTCN).
Submodule names follow the flax scopes, so a checkpoint leaf
trunk/block0_sep1/... maps to the state-dict key trunk.block0_sep1....

Every forward keeps the JAX layout and flags: input (B, T, F, 1) NHWC,
output (B, T // 2**len(filters), num_labels) sigmoid probabilities (or
logits) in float32; `train` selects batch statistics and dropout;
`trunk_only` returns the trunk's output as (B, T', F', 36) NHWC and
`head_input` takes exactly that, which is the split the dense-trunk
inference mode (ops/overlap.py) runs on.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from orcai_tpu_torch.models.layers import (
    BatchNorm,
    BiLSTM,
    Conv1d,
    ConvParams,
    Dropout,
    FrozenBiasConv,
    LSTM,
    SeparableConv,
    full,
    model_input,
    shard_of,
)

L2_SCALE = 0.001
TRUNK_CHANNELS = 36
TCN_DILATIONS = (1, 2, 4, 8, 16)


def _same_pool_pads(n: int, window: int, stride: int) -> tuple[int, int]:
    """(low, high) TF SAME padding of one dim: the extra cell goes high."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax nn.max_pool(x, (3, 2), strides=(2, 2), padding="SAME") on NCHW.

    SAME pads -inf on the high side first (1 row at T=736, 1 column at
    F=171); torch's MaxPool2d pads symmetrically, so pad explicitly. No
    window is padding only, so no -inf reaches an output or a gradient.
    """
    h_lo, h_hi = _same_pool_pads(x.shape[2], 3, 2)
    w_lo, w_hi = _same_pool_pads(x.shape[3], 2, 2)
    x = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=float("-inf"))
    return F.max_pool2d(x, (3, 2), stride=(2, 2))


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    x = model_input(layer, x)
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class ResNetTrunk(nn.Module):
    """Entry conv + residual separable-conv blocks with (2, 2) downsampling.

    `block_dropout` drops out after every residual block (ResNet1DConv).
    """

    def __init__(self, filters: Sequence[int], kernel_size: int, in_ch: int = 1,
                 dropout_rate: float = 0.0, block_dropout: bool = False):
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
        self.head_sep = SeparableConv(prev, TRUNK_CHANNELS, k)
        self.head_bn = BatchNorm(TRUNK_CHANNELS)
        self.block_dropout = Dropout(dropout_rate) if block_dropout else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, C, T, F) -> (B, 36, T / 2**n, ceil-halved F), NCHW.

        Sharded (tensor parallelism), each conv + BatchNorm computes its
        block of channels and the whole is gathered after the BatchNorm;
        a block's shortcut conv has the same channels as its second
        BatchNorm, so the two are sharded alike and added as blocks."""
        x = full(F.relu(self.entry_bn(self.entry_conv(x), train)), self.entry_bn)
        previous = x
        for bi in range(len(self.filters)):
            y = F.relu(x)
            y = getattr(self, f"block{bi}_sep1")(y)
            bn1 = getattr(self, f"block{bi}_bn1")
            y = full(F.relu(bn1(y, train)), bn1)
            y = getattr(self, f"block{bi}_sep2")(y)
            bn2 = getattr(self, f"block{bi}_bn2")
            y = max_pool_same(bn2(y, train))
            shortcut = getattr(self, f"block{bi}_shortcut")
            # 1x1 stride-2 SAME conv: no padding at any size
            x = full(y + F.conv2d(
                model_input(shortcut, previous), shortcut.weight.to(x.dtype),
                shortcut.bias.to(x.dtype), stride=2,
            ), bn2)
            previous = x
            if self.block_dropout is not None:
                x = self.block_dropout(x, train)
        return full(F.relu(self.head_bn(self.head_sep(x), train)), self.head_bn)


class _Detector(nn.Module):
    """What the three architectures share: the trunk, the forward's flags
    and layout, the dropout generator. A subclass supplies `head`.

    `dtype` is the compute dtype (float32 or bfloat16); parameters stay
    float32 and the logits are cast to float32 before the sigmoid.
    """

    def __init__(self, num_labels: int, filters: Sequence[int], kernel_size: int,
                 dropout_rate: float, dtype: torch.dtype, block_dropout: bool = False):
        super().__init__()
        self.num_labels = num_labels
        self.kernel_size = kernel_size
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.trunk = ResNetTrunk(filters, kernel_size, dropout_rate=dropout_rate,
                                 block_dropout=block_dropout)
        self.dropout = Dropout(dropout_rate)

    def set_dropout_generator(self, generator: torch.Generator) -> None:
        """The generator (on the model's device) every dropout layer draws
        its masks from, in the order the forward reaches them."""
        for module in self.modules():
            if isinstance(module, Dropout):
                module.generator = generator

    def set_data_parallel(self, rank: int | None, world: int = 1, group=None) -> None:
        """Train as block `rank` of a global batch split over `world`
        processes of `group` (default: the default group): global BatchNorm
        statistics and dropout masks (models/layers.py). rank None trains
        alone again."""
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.sync = False if rank is None else (group if group is not None else True)
            elif isinstance(module, Dropout):
                module.shard = None if rank is None else (int(rank), int(world))

    def head(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = False,
                return_logits: bool = False, trunk_only: bool = False,
                head_input: bool = False) -> torch.Tensor:
        if not head_input:
            x = self.trunk(x.permute(0, 3, 1, 2).to(self.dtype), train)
            x = x.permute(0, 2, 3, 1)  # NHWC, the flax trunk's layout
            if trunk_only:
                return x
        logits = self.head(x.to(self.dtype), train).float()
        return logits if return_logits else torch.sigmoid(logits)


def _add_dense_head(model: _Detector, in_features: int) -> None:
    """dense(128) -> relu -> BatchNorm -> dropout -> out over (B, T, C); the
    flax tree has no scope for it, so its layers sit on the detector."""
    model.dense = nn.Linear(in_features, 128)
    model.dense_bn = BatchNorm(128)
    model.out = nn.Linear(128, model.num_labels)


def _dense_head(model: _Detector, x: torch.Tensor, train: bool) -> torch.Tensor:
    x = F.relu(_linear(model.dense, x))
    # statistics over B * T: the channel goes to dim 1 for the normalization
    # (and a sharded block is gathered there, in BatchNorm's layout)
    x = full(model.dense_bn(x.transpose(1, 2), train), model.dense_bn).transpose(1, 2)
    x = model.dropout(x, train)
    return full(_linear(model.out, x), model.out, dim=2)


class ResNetLSTM(_Detector):
    """Conv-ResNet trunk + 2x BiLSTM + dense head (reference production arch)."""

    def __init__(
        self,
        num_labels: int,
        filters: Sequence[int] = (30, 40, 50, 60),
        kernel_size: int = 3,
        dropout_rate: float = 0.5,
        lstm_units: int = 128,
        n_freq_out: int = 11,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(num_labels, filters, kernel_size, dropout_rate, dtype)
        self.bilstm1 = BiLSTM(n_freq_out * TRUNK_CHANNELS, lstm_units)
        self.bilstm2 = BiLSTM(2 * lstm_units, lstm_units)
        _add_dense_head(self, 2 * lstm_units)

    def head(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, t, f, c = x.shape
        x = x.reshape(b, t, f * c)  # (B, 46, 11*36) frequency-major
        x = self.dropout(self.bilstm1(x, train), train)
        x = self.dropout(self.bilstm2(x, train), train)
        return _dense_head(self, x, train)


class ResNet1DConv(_Detector):
    """Conv-ResNet trunk + frequency-mean + wide Conv1D head. The Conv1D's
    kernel is as wide as the channel count after the mean (36)."""

    def __init__(
        self,
        num_labels: int,
        filters: Sequence[int] = (30, 40, 50, 60),
        kernel_size: int = 3,
        dropout_rate: float = 0.5,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(num_labels, filters, kernel_size, dropout_rate, dtype,
                         block_dropout=True)
        self.out_conv1d = Conv1d(TRUNK_CHANNELS, num_labels, TRUNK_CHANNELS)

    def head(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.dropout(x, train)
        x = x.mean(dim=2)  # frequency, dim 2 of NHWC -> (B, T, C)
        return full(self.out_conv1d(x.transpose(1, 2)), self.out_conv1d).transpose(1, 2)


class ResNetTCN(_Detector):
    """Conv-ResNet trunk + dilated temporal-conv head: a channel projection,
    residual [relu -> dilated Conv1D -> BN -> dropout] blocks at dilations
    1/2/4/8/16, then ResNetLSTM's dense head. `lstm_units` is the channel
    width (the parameter schema has no key of its own for it)."""

    def __init__(
        self,
        num_labels: int,
        filters: Sequence[int] = (30, 40, 50, 60),
        kernel_size: int = 3,
        dropout_rate: float = 0.5,
        lstm_units: int = 128,
        n_freq_out: int = 11,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(num_labels, filters, kernel_size, dropout_rate, dtype)
        self.proj = nn.Linear(n_freq_out * TRUNK_CHANNELS, lstm_units)
        for i, dilation in enumerate(TCN_DILATIONS):
            setattr(self, f"tcn{i}_conv", Conv1d(lstm_units, lstm_units, 3, dilation))
            setattr(self, f"tcn{i}_bn", BatchNorm(lstm_units))
        _add_dense_head(self, lstm_units)

    def head(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, t, f, c = x.shape
        x = full(_linear(self.proj, x.reshape(b, t, f * c)), self.proj, dim=2)
        x = x.transpose(1, 2)  # (B, C, T)
        for i in range(len(TCN_DILATIONS)):
            y = getattr(self, f"tcn{i}_conv")(F.relu(x))
            bn = getattr(self, f"tcn{i}_bn")
            y = full(bn(y, train), bn)
            x = x + self.dropout(y, train)
        return _dense_head(self, x.transpose(1, 2), train)


ORCAI_ARCHITECTURES = {
    "ResNetLSTM": ResNetLSTM,
    "ResNet1DConv": ResNet1DConv,
    "ResNetTCN": ResNetTCN,
}


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
    if arch not in ORCAI_ARCHITECTURES:
        raise ValueError(f"Unknown model architecture: {arch}")
    mp = orcai_parameter["model"]
    kwargs = dict(
        num_labels=len(orcai_parameter["calls"]),
        filters=tuple(mp["filters"]),
        kernel_size=mp["kernel_size"],
        # every parameter file has the key; a hand-made inference-only
        # parameter set may leave it out, and then nothing is dropped
        dropout_rate=mp.get("dropout_rate", 0.0),
        dtype=dtype,
    )
    if arch in ("ResNetLSTM", "ResNetTCN"):
        kwargs["lstm_units"] = mp["lstm_units"]
        kwargs["n_freq_out"] = _freq_after_trunk(input_shape[1], len(mp["filters"]))
    return ORCAI_ARCHITECTURES[arch](**kwargs)


# ------------------------------------------------------------ initialisers


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """Truncated normal (+-2 sigma) scaled to a variance of 1 / fan_in."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=g, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    # 0.8796...: the standard deviation of a unit normal truncated at +-2
    return (z * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)).float()


def _glorot_uniform(shape, fan_in: int, fan_out: int, g: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return ((torch.rand(shape, generator=g, dtype=torch.float64) * 2.0 - 1.0) * limit).float()


def _orthogonal(rows: int, cols: int, g: torch.Generator) -> torch.Tensor:
    """(rows, cols), rows >= cols, with orthonormal columns."""
    a = torch.randn((rows, cols), generator=g, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).float()


@torch.no_grad()
def init_variables(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh weights with the reference's initialisers, drawn on the CPU
    from a torch.Generator seeded with `seed` (the same weights on every
    device): lecun-normal conv, dense and 1-D conv kernels (fan-in: the
    kernel's cells times its input channels, 9 for a depthwise kernel),
    glorot-uniform LSTM input kernels, orthogonal recurrent kernels, LSTM
    bias zero with a unit forget-gate block, every other bias zero,
    BatchNorm scale 1 / bias 0 / mean 0 / variance 1. Returns the model.
    """
    g = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, LSTM):
            four_u, d = module.weight_ih.shape
            u = four_u // 4
            module.weight_ih.copy_(_glorot_uniform((four_u, d), d, four_u, g))
            module.weight_hh.copy_(_orthogonal(four_u, u, g))
            module.bias_ih.zero_()
            module.bias_ih[u : 2 * u] = 1.0
            module.bias_hh.zero_()
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        elif isinstance(module, (FrozenBiasConv, ConvParams, Conv1d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()  # input channels times the kernel's cells
            module.weight.copy_(_lecun_normal(tuple(w.shape), fan_in, g))
            if module.bias is not None:
                module.bias.zero_()
    return model


def l2_regularization(model: nn.Module) -> torch.Tensor:
    """l2(0.001) on the LSTM input kernels and the 128-dense kernel.

    As the reference places it: bilstm1 / bilstm2 `weight_ih` of both
    directions (never the recurrent kernel) and the kernel of the layer
    named exactly `dense` (not dense_bn, out or proj); scale * sum(x**2).
    A model without those layers has a zero penalty. A sharded kernel's
    squares are summed over the model group (each block once), a
    replicated one's counted once.
    """
    total = sharded = next(model.parameters()).new_zeros(())
    tp = None
    layers = [getattr(getattr(model, name, None), d, None)
              for name in ("bilstm1", "bilstm2") for d in ("fwd", "bwd")]
    for layer in [*layers, getattr(model, "dense", None)]:
        if layer is None:
            continue
        weight = layer.weight_ih if isinstance(layer, LSTM) else layer.weight
        square = weight.float().square().sum()
        if shard_of(layer) is None:
            total = total + square
        else:
            tp, sharded = shard_of(layer), sharded + square
    if tp is not None:
        total = total + tp.sum(sharded)
    return L2_SCALE * total
