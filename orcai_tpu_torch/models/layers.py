"""Building-block layers for the CRNN detectors, inference and training.

Counterpart of orcai_tpu/models/layers.py. Parameters are kept in float32
in torch layouts (conv OIHW, 1-D conv (out, in, k), linear (out, in), LSTM
weight_ih (4U, D)); each forward casts them to the dtype of its input, as
the flax layers cast theirs to the module dtype, so gradients reach the
float32 masters. Convolutions use TF-style SAME padding: for a span of k
cells (dilation counted) k - 1 cells in all, the extra one on the high side.

Like the flax modules, a layer that behaves differently in training takes
the mode as an argument (`train`) and ignores `nn.Module.training`.

In data-parallel training (each process of a group holding a contiguous
block of the global batch) BatchNorm's statistics and Dropout's masks are
those of the global batch, as they are under the reference's GSPMD
partitioning: BatchNorm.sync all-reduces the statistics over the group,
Dropout.shard draws the global mask and keeps the process's rows.

In tensor-parallel training (parallel/sharding_rules.py) a layer whose
weight is sharded over the mesh's "model" axis holds a `tp` (a ModelShard):
it computes its block of output channels from its whole input, which it
takes through `tp.copy` (the input's gradient is summed over the model
group); the model gathers the blocks where a whole tensor is needed
(models/crnn.py). A BiLSTM whose gate columns are sharded runs its steps
in a loop that gathers the gate pre-activations every step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.99  # weight of the old running value, as flax counts it
BN_EPS = 1e-3


def shard_of(module: nn.Module):
    """The ModelShard of a layer whose parameters are sharded, else None."""
    return getattr(module, "tp", None)


def model_input(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x as the input of a layer whose output channels may be sharded."""
    tp = shard_of(module)
    return x if tp is None else tp.copy(x)


def full(x: torch.Tensor, module: nn.Module, dim: int = 1) -> torch.Tensor:
    """The whole of x along `dim` where `module` computed only its block of
    that dim (x itself otherwise)."""
    tp = shard_of(module)
    return x if tp is None else tp.gather(x, dim)


def _same_pads(kernel_size: int, dilation: int = 1) -> tuple[int, int]:
    """(low, high) SAME padding of a stride-1 conv, as XLA splits it."""
    total = dilation * (kernel_size - 1)
    return total // 2, total - total // 2


def _same_pad(kernel_size: int) -> int:
    lo, hi = _same_pads(kernel_size)
    if lo != hi:
        raise ValueError(f"symmetric SAME padding needs an odd kernel, got {kernel_size}")
    return lo


class FrozenBiasConv(nn.Module):
    """Dense conv with bias, stride 1, SAME padding (flax FrozenBiasConv).

    It feeds a BatchNorm, so its bias has a zero gradient by construction;
    as in the reference (stop_gradient) the bias is read but never trained.
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int):
        super().__init__()
        self.pad = _same_pad(kernel_size)
        self.weight = nn.Parameter(
            torch.zeros(features, in_ch, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = model_input(self, x)
        return F.conv2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=self.pad
        )


class ConvParams(nn.Module):
    """Parameter holder matching a flax nn.Conv scope (weight [+ bias])."""

    def __init__(self, out_ch: int, in_ch: int, kernel_size: int, bias: bool,
                 frozen_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch, kernel_size, kernel_size)
        )
        self.bias = (
            nn.Parameter(torch.zeros(out_ch), requires_grad=not frozen_bias)
            if bias else None
        )


class SeparableConv(nn.Module):
    """Depthwise + pointwise conv run as ONE dense conv (Keras semantics).

    Like the flax layer it composes K[o, i, h, w] = dw[i, h, w] * pw[o, i]
    in float32 (a single product per element, so K is bit-equal to the flax
    einsum) and casts K to the compute dtype. Every use in the trunk feeds
    a BatchNorm, so the pointwise bias is frozen (flax frozen_bias=True).
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int):
        super().__init__()
        self.pad = _same_pad(kernel_size)
        self.depthwise = ConvParams(in_ch, 1, kernel_size, bias=False)
        self.pointwise = ConvParams(features, in_ch, 1, bias=True, frozen_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (out, in, 1, 1) * (1, in, kh, kw) -> (out, in, kh, kw); the
        # replicated depthwise factor enters each block of output channels
        depthwise = model_input(self.pointwise, self.depthwise.weight)
        x = model_input(self.pointwise, x)
        k = self.pointwise.weight * depthwise.permute(1, 0, 2, 3)
        return F.conv2d(
            x, k.to(x.dtype), self.pointwise.bias.to(x.dtype), padding=self.pad
        )


class Conv1d(nn.Module):
    """1-D conv over (B, C, T), stride 1, SAME padding, trainable bias
    (flax nn.Conv with a 1-D kernel). An even kernel pads (k - 1) // 2 low
    and k // 2 high; a dilated kernel of 3 pads its dilation on each side."""

    def __init__(self, in_ch: int, features: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pads = _same_pads(kernel_size, dilation)
        self.weight = nn.Parameter(torch.zeros(features, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = model_input(self, x)
        return F.conv1d(
            F.pad(x, self.pads), self.weight.to(x.dtype), self.bias.to(x.dtype),
            dilation=self.dilation,
        )


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 (flax nn.BatchNorm(momentum=0.99, epsilon=1e-3)).

    As in flax, the normalization runs in float32 and the result is cast
    back to the input dtype. In training the batch is normalized with its
    own mean and biased variance, and the same biased variance goes into
    the running average, ra = 0.99 * ra + 0.01 * batch. F.batch_norm hands
    out the unbiased variance (and counts momentum the other way round), so
    it runs here on scratch buffers with momentum 1, which leaves the
    batch's own statistics in them, and the variance is scaled back by
    (n - 1) / n, n being every element of a channel (B * T for a sequence).

    With `sync` (data-parallel training: True for the default group, or
    the process group of the data ranks) the mean and the biased variance
    are those of every process's batch: two all-reduces over the group, of
    the per-channel sums and then of the squared deviations from the
    global mean, both differentiable (their backward all-reduces the
    gradients), and n counts the global batch. Under tensor parallelism
    the layer holds its block of the channels and normalizes only those.
    """

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.sync = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            y = F.batch_norm(
                x.float(), self.running_mean, self.running_var, self.weight,
                self.bias, training=False, eps=self.eps,
            )
            return y.to(x.dtype)
        if self.sync is not False:
            return self._forward_sync(x)
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(
            x.float(), mean, var, self.weight, self.bias, training=True,
            momentum=1.0, eps=self.eps,
        )
        with torch.no_grad():
            # out of place: the backward keeps the scratch buffers
            var = var * ((n - 1) / n) if n > 1 else var
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return y.to(x.dtype)

    def _forward_sync(self, x: torch.Tensor) -> torch.Tensor:
        group = None if self.sync is True else self.sync
        xf = x.float()
        dims = [d for d in range(xf.dim()) if d != 1]
        shape = [1, -1] + [1] * (xf.dim() - 2)
        # every process holds a block of the same size
        n = xf.numel() // xf.shape[1] * dist.get_world_size(group)
        mean = dist_nn.all_reduce(xf.sum(dims), group=group) / n
        centered = xf - mean.view(shape)
        var = dist_nn.all_reduce((centered * centered).sum(dims), group=group) / n
        y = centered * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1 - BN_MOMENTUM)
        # F.batch_norm's output layout (a dropout mask drawn next fills
        # memory in order, so the layout is part of the result)
        channels_last = (x.dim() == 4 and not x.is_contiguous()
                         and x.is_contiguous(memory_format=torch.channels_last))
        return y.to(x.dtype).contiguous(
            memory_format=torch.channels_last if channels_last else torch.contiguous_format
        )


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit torch.Generator.

    F.dropout draws from the global state; here the mask is a Bernoulli
    draw from `generator` (set by the model, on the model's device), so a
    checkpoint can store the generator's state and a resumed run draws the
    masks an uninterrupted one would. Kept values are scaled by
    1 / (1 - rate), as flax nn.Dropout scales them.

    With `shard` = (rank, world) the input is block `rank` of a global
    batch `world` times its size: the mask is drawn for the global batch
    (the generators of all processes move in step) and the block's rows
    are kept, so the masks do not depend on the number of processes.
    """

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1)")
        self.rate = float(rate)
        self.generator: torch.Generator | None = None
        self.shard: tuple[int, int] | None = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "dropout in training mode needs a generator: call the model's "
                "set_dropout_generator first"
            )
        keep = 1.0 - self.rate
        if self.shard is None:
            mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        else:
            rank, world = self.shard
            b = x.shape[0]
            mask = expanded_like(x, 0, world).bernoulli_(keep, generator=self.generator)
            mask = mask[rank * b : (rank + 1) * b]
        return x * mask * (1.0 / keep)


def expanded_like(x: torch.Tensor, dim: int, factor: int) -> torch.Tensor:
    """An empty tensor of x's shape with `factor` times its size along
    `dim`, laid out in memory as torch.empty_like lays out such a tensor in
    one process: a draw fills memory in order, so the layout decides which
    element gets which number (an LSTM's batch-first output, say, is
    time-major)."""
    shape = list(x.shape)
    shape[dim] *= factor
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    span = 1
    for d in reversed(order):
        if x.shape[d] != 1 and x.stride(d) != span:
            return x.new_empty(shape)  # not dense: empty_like is contiguous
        span *= x.shape[d]
    inverse = sorted(range(x.dim()), key=order.__getitem__)
    return x.new_empty([shape[d] for d in order]).permute(inverse)


class LSTM(nn.Module):
    """Weights of one LSTM direction, matching a flax LSTM scope.

    Keras gate math: gate order [input, forget, cell, output], which is
    torch's i, f, g, o; the single Keras bias sits in bias_ih. torch's
    second bias, bias_hh, is a zero buffer and no parameter: trained, it
    would take bias_ih's gradient too and the layer would stop being the
    one-bias Keras LSTM. BiLSTM runs both directions in one call.
    """

    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(4 * units, in_features))
        self.weight_hh = nn.Parameter(torch.zeros(4 * units, units))
        self.bias_ih = nn.Parameter(torch.zeros(4 * units))
        self.register_buffer("bias_hh", torch.zeros(4 * units))

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
    card); the submodules only hold the per-direction weights. `train`
    goes to torch.lstm so that cuDNN keeps what its backward needs.
    """

    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.units = units
        self.fwd = LSTM(in_features, units)
        self.bwd = LSTM(in_features, units)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if shard_of(self.fwd) is not None:
            return self._forward_sharded(x)
        h0 = x.new_zeros(2, x.shape[0], self.units)
        weights = self.fwd.flat_weights(x.dtype) + self.bwd.flat_weights(x.dtype)
        return torch.lstm(
            x, (h0, h0), weights, True, 1, 0.0, train, True, True
        )[0]

    def _forward_sharded(self, x: torch.Tensor) -> torch.Tensor:
        """Both directions step by step, as torch.lstm computes them: each
        process holds a block of the [i f g o] gate columns, so every step
        gathers the two directions' gate pre-activations over the model
        group. The output is time-major in memory, as torch.lstm's
        batch-first output is (a dropout mask drawn on it fills memory in
        order)."""
        tp = shard_of(self.fwd)
        xt = tp.copy(x).transpose(0, 1)  # (T, B, D)
        cells = (self.fwd, self.bwd)
        inputs = [F.linear(xt, c.weight_ih.to(x.dtype), c.bias_ih.to(x.dtype)) for c in cells]
        recurrent = [c.weight_hh.to(x.dtype) for c in cells]
        steps = xt.shape[0]
        h = c = x.new_zeros(2, x.shape[0], self.units)
        out = []
        for s in range(steps):
            hs = tp.copy(h)
            gates = torch.stack([inputs[0][s] + hs[0] @ recurrent[0].T,
                                 inputs[1][steps - 1 - s] + hs[1] @ recurrent[1].T])
            i, f, g, o = tp.gather(gates, 2).chunk(4, dim=2)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        forward = torch.stack([h[0] for h in out])
        backward = torch.stack([h[1] for h in reversed(out)])
        return torch.cat([forward, backward], dim=2).transpose(0, 1)
