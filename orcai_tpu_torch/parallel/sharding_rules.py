"""Parameter sharding rules for the CRNN models (tensor parallelism).

Counterpart of orcai_tpu/parallel/sharding_rules.py, with its rules: LSTM
input and recurrent kernels and dense kernels shard their output (gate or
unit) dimension over the mesh's "model" axis, convolution kernels their
output channels (a depthwise factor stays replicated), Conv1D kernels their
last dimension, biases and BatchNorm scales the same dimension, and a leaf
whose dimension the axis does not divide stays replicated. A spec is
written in flax's layout (kernels (..., in, out)), as the reference's
PartitionSpec reads; in the port's layouts every sharded dimension is dim
0, and the process at model coordinate r holds the block JAX places on the
device at that coordinate (for an LSTM kernel a block of [i f g o] gate
columns, not a share of each gate's units).

Where GSPMD partitions the activations and inserts the collectives, here
the layers do it (models/layers.py, models/crnn.py) through the model's
ModelShard, as Megatron-LM's column-parallel layers do: a layer whose
weight is sharded computes its block of output channels from its whole
input; `copy` hands it that input and sums the input's gradient over the
model group (every block's contribution); `gather` makes the whole output
from the blocks, which every model rank then uses alike, so its backward
keeps the rank's own block and sums nothing; `sum` adds a partial scalar
(the l2 term's sharded weights) over the group, its backward the identity.
A gather is an all-reduce of a zero-filled whole buffer, which is exact
(adding zeros) and needs no all-gather from the backend (gloo ranks that
share one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from orcai_tpu_torch.io.model_store import _LSTM_NAMES, _LSTM_SCOPES
from orcai_tpu_torch.models.layers import LSTM, BatchNorm, expanded_like, shard_of

MODEL = "model"
# flax's layout -> the port's, as io/model_store.py converts a leaf:
# torch dim i is flax dim _TO_TORCH[ndim][i]
_TO_TORCH = {1: (0,), 2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _spec_for(path_keys: tuple[str, ...], ndim: int) -> tuple:
    """The spec of one parameter, its output dimension over "model", in
    flax's layout: () is replicated."""
    last = path_keys[-1]
    parent = path_keys[-2] if len(path_keys) > 1 else ""
    if last in ("kernel", "recurrent_kernel"):
        if ndim == 2:  # dense and LSTM kernels (in, out)
            return (None, MODEL)
        if ndim == 4:  # conv kernels (kh, kw, in, out)
            # a depthwise factor (kh, kw, 1, in) indexes the INPUT channels
            # of the composed kernel: it stays whole beside the pointwise's
            return () if parent == "depthwise" else (None, None, None, MODEL)
        if ndim == 3:  # Conv1D (k, in, out)
            return (None, None, MODEL)
    if last in ("bias", "scale"):
        return (MODEL,) if ndim == 1 else ()
    return ()


def flax_path(name: str, ndim: int) -> tuple[str, ...]:
    """The flax parameter path of a state-dict key (io/model_store.py's
    names): trunk.entry_conv.weight -> (trunk, entry_conv, kernel)."""
    *scopes, leaf = name.split(".")
    if scopes and scopes[-1] in _LSTM_SCOPES.values():
        scopes[-1] = {v: k for k, v in _LSTM_SCOPES.items()}[scopes[-1]]
        leaf = {v: k for k, v in _LSTM_NAMES.items()}[leaf]
    elif leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    return (*scopes, leaf)


def params_shardings(model: nn.Module, mesh) -> dict[str, tuple]:
    """{parameter name: spec in flax's layout} for every parameter of the
    model (frozen biases too: they are flax parameters). A leaf whose
    sharded dimension the "model" axis does not divide (a 7-label head on
    a 2-way axis) stays replicated; a model axis of 1 replicates all."""
    n_model = mesh.shape[MODEL]
    specs = {}
    for name, p in model.named_parameters():
        spec = _spec_for(flax_path(name, p.ndim), p.ndim)
        if MODEL in spec and p.shape[_torch_dim(spec, p.ndim)] % n_model:
            spec = ()
        specs[name] = spec
    return specs


def _torch_dim(spec: tuple, ndim: int) -> int:
    return _TO_TORCH[ndim].index(spec.index(MODEL))


class ModelShard:
    """This process's block `index` of `size` along the model axis, and
    the group of the processes that hold the other blocks (see the module
    docstring). `names` are the state-dict keys kept as blocks."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        self.names: set[str] = set()

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim, self)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self) if x.requires_grad else x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard, ctx.n = dim, shard, x.shape[dim]
        whole = expanded_like(x, dim, shard.size).zero_()
        whole.narrow(dim, shard.index * ctx.n, ctx.n).copy_(x)
        # the same memory as a contiguous view (the backend reduces those)
        order = sorted(range(whole.dim()), key=lambda d: -whole.stride(d))
        dist.all_reduce(whole.permute(order), group=shard.group)
        return whole

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.shard.index * ctx.n, ctx.n), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        x = x.clone()
        dist.all_reduce(x, group=shard.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# what a layer keeps beside its sharded parameters, cut the same way
_SIDE_BUFFERS = {BatchNorm: ("running_mean", "running_var"), LSTM: ("bias_hh",)}


@torch.no_grad()
def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Keep on this process only its block of every sharded parameter
    (params_shardings) and of the buffers beside it (a BatchNorm's running
    statistics, an LSTM's zero bias_hh); each layer that holds a block
    gets the model's ModelShard as `tp`. Returns the model; an optimizer
    made afterwards steps the blocks (Adam works elementwise)."""
    n_model = mesh.shape[MODEL]
    shard = ModelShard(mesh.model_group, mesh.model_index, n_model)
    for name, spec in params_shardings(model, mesh).items():
        if MODEL not in spec:
            continue
        module_name, leaf = name.rsplit(".", 1)
        module = model.get_submodule(module_name)
        param = getattr(module, leaf)
        block = _block(param, _torch_dim(spec, param.ndim), shard)
        setattr(module, leaf, nn.Parameter(block, requires_grad=param.requires_grad))
        shard.names.add(name)
        for buffer in _SIDE_BUFFERS.get(type(module), ()):
            if f"{module_name}.{buffer}" not in shard.names:
                module.register_buffer(buffer, _block(getattr(module, buffer), 0, shard))
                shard.names.add(f"{module_name}.{buffer}")
        module.tp = shard
    return model


def _block(t: torch.Tensor, dim: int, shard: ModelShard) -> torch.Tensor:
    n = t.shape[dim] // shard.size
    return t.narrow(dim, shard.index * n, n).clone()


@torch.no_grad()
def gather_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """The whole state dict of a sharded model, on every model rank (the
    blocks gathered over the model group); a model without blocks gives
    its own state dict."""
    shard = next((shard_of(m) for m in model.modules() if shard_of(m) is not None), None)
    state = model.state_dict()
    if shard is None:
        return state
    return {k: _Gather.apply(v, 0, shard) if k in shard.names else v for k, v in state.items()}
