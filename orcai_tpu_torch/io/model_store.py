"""Model directory loading and the flax -> torch weight conversion.

Counterpart of orcai_tpu/io/model_store.py (load side, msgpack format).
A model dir holds orcai_parameter.json, model_shape.json and
<name>.msgpack, the flax variables {"params", "batch_stats"}, which
io/msgpack_lite.py decodes without the msgpack package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.jsonio import read_json
from orcai_tpu_torch.io.msgpack_lite import unpackb
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.utils.device import resolve_device

# the model shipped with the repository, found by path beside this package
DEFAULT_MODEL_DIR = (
    Path(__file__).resolve().parents[2] / "orcai_tpu" / "models_data" / "orcai-v1"
)

# flax leaf name -> torch name, per collection
_PARAM_NAMES = {"scale": "weight", "bias": "bias", "kernel": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_LSTM_NAMES = {"kernel": "weight_ih", "recurrent_kernel": "weight_hh", "bias": "bias_ih"}
_LSTM_SCOPES = {"forward": "fwd", "backward": "bwd"}


def _leaves(tree: dict, path: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def convert_flax_variables(variables: dict) -> dict[str, np.ndarray]:
    """flax {"params", "batch_stats"} tree of numpy leaves -> state dict.

    Layout rules: conv kernels HWIO -> OIHW; Dense (in, out) -> (out, in);
    BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
    a Keras LSTM's kernel (D, 4U) -> weight_ih (4U, D), recurrent_kernel
    (U, 4U) -> weight_hh (4U, U), bias -> bias_ih and a zero bias_hh (the
    gate order i, f, c, o is torch's i, f, g, o). Raises on any leaf it
    does not know, so no checkpoint leaf is silently dropped.
    """
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections: {sorted(unknown)}")
    state: dict[str, np.ndarray] = {}
    for collection, names in (("params", _PARAM_NAMES), ("batch_stats", _STAT_NAMES)):
        for path, leaf in _leaves(variables.get(collection, {})):
            *scopes, name = path
            arr = np.asarray(leaf, np.float32)
            if scopes and scopes[-1] in _LSTM_SCOPES and collection == "params":
                if name not in _LSTM_NAMES:
                    raise ValueError(f"unknown LSTM leaf {'/'.join(path)}")
                scopes[-1] = _LSTM_SCOPES[scopes[-1]]
                torch_name = _LSTM_NAMES[name]
                if arr.ndim == 2:
                    arr = arr.T
                elif name == "bias":
                    state[".".join(scopes + ["bias_hh"])] = np.zeros_like(arr)
            else:
                if name not in names:
                    raise ValueError(f"unknown checkpoint leaf {'/'.join(path)}")
                torch_name = names[name]
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.T  # Dense (in, out) -> (out, in)
            key = ".".join(scopes + [torch_name])
            if key in state:
                raise ValueError(f"two checkpoint leaves map to {key}")
            state[key] = np.array(arr, order="C")  # writable copy
    return state


def load_variables(path: Path | str) -> dict:
    """Untyped load of a flax msgpack checkpoint: nested dict of numpy."""
    return unpackb(Path(path).read_bytes())


def load_orcai_model(
    model_dir: Path | str | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
):
    """Load (model in eval mode on `device`, orcai_parameter, shape).

    `dtype` is the CRNN compute dtype; the parameters stay float32.
    """
    dev = resolve_device(device)
    model_dir = Path(model_dir) if model_dir is not None else DEFAULT_MODEL_DIR
    orcai_parameter = read_json(model_dir / "orcai_parameter.json")
    shape = read_json(model_dir / "model_shape.json")
    msgpack_path = model_dir / f"{orcai_parameter['name']}.msgpack"
    if not msgpack_path.exists():
        raise ValueError(
            f"Couldn't find model weights {msgpack_path.name} in {model_dir} "
            "(only flax msgpack checkpoints are read by this package)"
        )
    model = build_model(orcai_parameter, shape["input_shape"], dtype=dtype)
    state = convert_flax_variables(load_variables(msgpack_path))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(dev).eval(), orcai_parameter, shape
