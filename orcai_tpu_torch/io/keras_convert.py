"""Reference-format checkpoints -> flax variables, without Keras or h5py
(counterpart of the reading half of orcai_tpu/io/keras_convert.py).

Upstream orcAI ships its models as `.keras` archives (a zip holding
`model.weights.h5`) and older model dirs as a bare `model_weights.h5`.
`load_keras_checkpoint` and `load_keras_weights_h5` read those files with
io/hdf5.py and return the flax {"params", "batch_stats"} tree of float32
numpy arrays that the JAX package's `keras_to_flax_variables` returns, so
io/model_store.py::convert_flax_variables takes it unchanged.

The weights are matched to the reference graph (the JAX package's
`build_keras_model`, ResNetLSTM and ResNet1DConv only) by the sequence of
its weighted layers, which `keras_weighted_layers` writes out with every
shape; a file that disagrees raises on the first mismatch. Two layouts:

- Keras 3 (`model.weights.h5`, also under a bare name): the group
  `layers/<snake_case(class)>[_k]/vars/<i>`, where k counts the layers of
  that class in the model's layer order, not the layer's own name; a
  Bidirectional keeps its weights in `forward_layer/cell/vars/0..2` and
  `backward_layer/cell/vars/0..2`.
- Keras 2 legacy (the `layer_names` and `weight_names` attributes, under
  `model_weights/` in a whole-model file): by position among the layers
  that have weights, as Keras loads them.

Keras stores a SeparableConv2D depthwise kernel as (kh, kw, in, 1); flax's
grouped conv takes (kh, kw, 1, in), the transpose of the trailing axes. The
LSTM's fused kernels (gate order i, f, c, o) and BatchNorm's four vectors
need no permutation.
"""

from __future__ import annotations

import math
import zipfile
from pathlib import Path

import numpy as np

from orcai_tpu_torch.io.hdf5 import H5File, H5Group

_SNAKE = {"Conv2D": "conv2d", "SeparableConv2D": "separable_conv2d",
          "BatchNormalization": "batch_normalization", "Bidirectional": "bidirectional",
          "Dense": "dense", "Conv1D": "conv1d"}


def keras_weighted_layers(orcai_parameter: dict, input_shape=(736, 171, 1)) -> list:
    """(Keras class, flax scope, weight shapes) of each layer with weights
    of the reference graph, in the Keras model's layer order: the entry
    conv and BN, per block (separable conv, BN) twice and the shortcut
    conv, the head's separable conv and BN, then two Bidirectional LSTMs,
    Dense, BN and Dense (ResNetLSTM) or one Conv1D (ResNet1DConv)."""
    arch = orcai_parameter["architecture"]
    if arch not in ("ResNetLSTM", "ResNet1DConv"):
        raise ValueError(
            f"no reference Keras equivalent for architecture {arch!r}; "
            "only ResNetLSTM / ResNet1DConv models can be exported to or "
            "loaded from .keras"
        )
    mp = orcai_parameter["model"]
    ks, n_labels = mp["kernel_size"], len(orcai_parameter["calls"])

    def conv(scope, kh, kw, cin, cout):
        return ("Conv2D", scope, [(kh, kw, cin, cout), (cout,)])

    def sep(scope, cin, cout):
        return ("SeparableConv2D", scope, [(ks, ks, cin, 1), (1, 1, cin, cout), (cout,)])

    def bn(scope, n):
        return ("BatchNormalization", scope, [(n,)] * 4)

    layers = [conv(("trunk", "entry_conv"), ks, ks, input_shape[2], 16),
              bn(("trunk", "entry_bn"), 16)]
    channels, width = 16, input_shape[1]
    for bi, size in enumerate(mp["filters"]):
        layers += [sep(("trunk", f"block{bi}_sep1"), channels, size),
                   bn(("trunk", f"block{bi}_bn1"), size),
                   sep(("trunk", f"block{bi}_sep2"), size, size),
                   bn(("trunk", f"block{bi}_bn2"), size),
                   conv(("trunk", f"block{bi}_shortcut"), 1, 1, channels, size)]
        channels, width = size, math.ceil(width / 2)  # stride-2 "same" pooling
    layers += [sep(("trunk", "head_sep"), channels, 36), bn(("trunk", "head_bn"), 36)]
    if arch == "ResNetLSTM":
        units, features = mp["lstm_units"], width * 36
        for i in (1, 2):
            lstm = [(features, 4 * units), (units, 4 * units), (4 * units,)]
            layers.append(("Bidirectional", (f"bilstm{i}",), lstm * 2))
            features = 2 * units
        layers += [("Dense", ("dense",), [(features, 128), (128,)]), bn(("dense_bn",), 128),
                   ("Dense", ("out",), [(128, n_labels), (n_labels,)])]
    else:
        # Conv1D(kernel_size=x.shape[2]) after the frequency mean: the 36 channels
        layers.append(("Conv1D", ("out_conv1d",), [(36, 36, n_labels), (n_labels,)]))
    return layers


def _keras3_weights(root: H5Group, layers: list) -> list[list[np.ndarray]]:
    """Each layer's weights from `layers/<snake_case(class)>[_k]/vars`."""
    counts: dict[str, int] = {}
    out = []
    for cls, _, shapes in layers:
        k = counts.get(cls, 0)
        counts[cls] = k + 1
        group = f"layers/{_SNAKE[cls]}" + (f"_{k}" if k else "")
        if cls == "Bidirectional":
            paths = [f"{group}/{side}_layer/cell/vars/{i}"
                     for side in ("forward", "backward") for i in range(3)]
        else:
            paths = [f"{group}/vars/{i}" for i in range(len(shapes))]
        for path in paths:
            if path not in root:
                raise ValueError(f"{root.file.name}: no weight {path} for the reference "
                                 f"graph's {cls} number {k}")
        out.append([root[p].read() for p in paths])
    for cls, n in counts.items():
        extra = f"layers/{_SNAKE[cls]}_{n}"
        if extra in root:
            raise ValueError(f"{root.file.name}: {extra} is one {cls} more than the "
                             f"reference graph's {n}")
    return out


def _text(value) -> str:
    return value.decode("utf-8") if isinstance(value, bytes) else str(value)


def _legacy_weights(group: H5Group, layers: list) -> list[list[np.ndarray]]:
    """Each layer's weights from a Keras 2 weight file: the groups of
    `layer_names` that have `weight_names`, by position."""
    weighted = []
    for name in (_text(n) for n in np.ravel(group.attrs["layer_names"])):
        names = [_text(n) for n in np.ravel(group[name].attrs["weight_names"])]
        if names:
            weighted.append((name, names))
    if len(weighted) != len(layers):
        raise ValueError(f"{group.file.name}: {len(weighted)} layers with weights, the "
                         f"reference graph has {len(layers)}")
    out = []
    for (name, names), (cls, _, shapes) in zip(weighted, layers):
        if len(names) != len(shapes):
            raise ValueError(f"{group.file.name}: layer {name} has {len(names)} weights, "
                             f"the reference graph's {cls} has {len(shapes)}")
        out.append([group[name][w].read() for w in names])
    return out


def _to_flax(layers: list, weights: list[list[np.ndarray]], where: str) -> dict:
    """The flax tree of `keras_to_flax_variables`, every shape checked."""
    params: dict = {}
    stats: dict = {}

    def put(tree, scope, value):
        for key in scope[:-1]:
            tree = tree.setdefault(key, {})
        tree[scope[-1]] = value

    for (cls, scope, shapes), values in zip(layers, weights):
        for shape, value in zip(shapes, values):
            if tuple(value.shape) != shape or value.dtype.kind != "f":
                raise ValueError(f"{where}: {cls} {'/'.join(scope)} weight of shape "
                                 f"{tuple(value.shape)} ({value.dtype}), the reference "
                                 f"graph has {shape}")
        w = [np.asarray(v, np.float32) for v in values]
        if cls == "SeparableConv2D":
            put(params, scope, {"depthwise": {"kernel": np.transpose(w[0], (0, 1, 3, 2))},
                                "pointwise": {"kernel": w[1], "bias": w[2]}})
        elif cls == "BatchNormalization":
            put(params, scope, {"scale": w[0], "bias": w[1]})
            put(stats, scope, {"mean": w[2], "var": w[3]})
        elif cls == "Bidirectional":
            names = ("kernel", "recurrent_kernel", "bias")
            put(params, scope, {"forward": dict(zip(names, w[:3])),
                                "backward": dict(zip(names, w[3:]))})
        else:
            put(params, scope, {"kernel": w[0], "bias": w[1]})
    return {"params": params, "batch_stats": stats}


def load_keras_checkpoint(path: Path | str, orcai_parameter: dict,
                          input_shape=(736, 171, 1)) -> dict:
    """Load a reference `.keras` archive (its `model.weights.h5`) as flax
    variables."""
    with zipfile.ZipFile(path) as archive:
        if "model.weights.h5" not in archive.namelist():
            raise ValueError(f"{path}: no model.weights.h5 in the archive")
        data = archive.read("model.weights.h5")
    layers = keras_weighted_layers(orcai_parameter, input_shape)
    root = H5File(data, name=f"{path}:model.weights.h5").root
    return _to_flax(layers, _keras3_weights(root, layers), str(path))


def load_keras_weights_h5(path: Path | str, orcai_parameter: dict,
                          input_shape=(736, 171, 1)) -> dict:
    """Load `model_weights.h5` (a Keras 3 weight file under a bare name, or
    a Keras 2 legacy weight or whole-model file) as flax variables."""
    layers = keras_weighted_layers(orcai_parameter, input_shape)
    root = H5File(path).root
    group = root["model_weights"] if "model_weights" in root else root
    if "layer_names" in group.attrs:
        weights = _legacy_weights(group, layers)
    else:
        weights = _keras3_weights(root, layers)
    return _to_flax(layers, weights, str(path))
