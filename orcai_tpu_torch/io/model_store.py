"""Model directory save/load and the flax <-> torch weight conversion.

Counterpart of orcai_tpu/io/model_store.py (msgpack format). A model dir
holds

    orcai_parameter.json
    model_shape.json
    <name>.msgpack          flax variables {"params", "batch_stats"}
    <name>.opt.pt           optimizer state (torch.save; optional, for resume)
    <name>.opt.msgpack      optax's optimizer state, in a directory the JAX
                            package trained (read, never written, here)
    train_state.json        epochs run (optional)
    training_history.json   per-epoch metrics (written by the trainer)

The weights are stored in flax's layout and msgpack framing
(io/msgpack_lite.py, no msgpack package), so the JAX package loads a
directory written here and this package loads one written there. The
optimizer state this package writes is its own <name>.opt.pt; a directory
the JAX package trained holds optax's <name>.opt.msgpack instead, which
`load_optax_adam_state` reads into torch.optim.Adam's state.
Loading falls back to a reference-format `<name>.keras` archive and then to
a `model_weights.h5`, read without Keras or h5py (io/keras_convert.py), so
reference model dirs are drop-in usable.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.jsonio import read_json, write_json
from orcai_tpu_torch.io.keras_convert import load_keras_checkpoint, load_keras_weights_h5
from orcai_tpu_torch.io.msgpack_lite import packb, unpackb
from orcai_tpu_torch.models import build_model
from orcai_tpu_torch.utils.device import resolve_device

# the models shipped with the repository, found by path beside this package
MODELS_DATA_DIR = Path(__file__).resolve().parents[2] / "orcai_tpu" / "models_data"
DEFAULT_MODEL_DIR = MODELS_DATA_DIR / "orcai-v1"


def bundled_models() -> list[str]:
    """Names of the models shipped with the repository."""
    if not MODELS_DATA_DIR.is_dir():
        return []
    return sorted(p.name for p in MODELS_DATA_DIR.iterdir()
                  if p.is_dir() and not p.name.startswith("."))

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

    Layout rules: conv kernels HWIO -> OIHW; 1-D conv kernels (k, in, out)
    -> (out, in, k); Dense (in, out) -> (out, in); BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
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
                elif arr.ndim == 3:
                    arr = arr.transpose(2, 1, 0)  # (k, in, out) -> (out, in, k)
                elif arr.ndim == 2:
                    arr = arr.T  # Dense (in, out) -> (out, in)
            key = ".".join(scopes + [torch_name])
            if key in state:
                raise ValueError(f"two checkpoint leaves map to {key}")
            state[key] = np.array(arr, order="C")  # writable copy
    return state


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


def _set_leaf(tree: dict, path: list[str], leaf: np.ndarray) -> None:
    for scope in path[:-1]:
        tree = tree.setdefault(scope, {})
    if path[-1] in tree:
        raise ValueError(f"two state-dict keys map to {'/'.join(path)}")
    tree[path[-1]] = np.array(leaf, order="C")


def _sorted_tree(tree: dict) -> dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def to_flax_variables(state_dict: dict) -> dict:
    """State dict (tensors or numpy) -> flax {"params", "batch_stats"} tree
    of float32 numpy leaves: the exact inverse of convert_flax_variables.

    Conv kernels OIHW -> HWIO, 1-D conv kernels (out, in, k) -> (k, in,
    out), linear and LSTM kernels transposed back, BatchNorm names back,
    bias_ih -> bias. An LSTM's bias_hh must be zero (flax has one bias)
    and is dropped; anything else raises, as does an unknown key.
    """
    reverse_lstm = {v: k for k, v in _LSTM_NAMES.items()}
    reverse_scopes = {v: k for k, v in _LSTM_SCOPES.items()}
    reverse_stats = {v: k for k, v in _STAT_NAMES.items()}
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *scopes, name = key.split(".")
        arr = _to_numpy(value)
        if scopes and scopes[-1] in reverse_scopes:
            scopes[-1] = reverse_scopes[scopes[-1]]
            if name == "bias_hh":
                if np.any(arr != 0):
                    raise ValueError(
                        f"{key} is not zero: the flax LSTM has one bias, so "
                        "these weights cannot be exported"
                    )
                continue
            if name not in reverse_lstm:
                raise ValueError(f"unknown LSTM state-dict key {key}")
            _set_leaf(variables["params"], scopes + [reverse_lstm[name]],
                      arr.T if arr.ndim == 2 else arr)
        elif name in reverse_stats:
            _set_leaf(variables["batch_stats"], scopes + [reverse_stats[name]], arr)
        elif name == "bias":
            _set_leaf(variables["params"], scopes + ["bias"], arr)
        elif name == "weight":
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)  # (out, in, k) -> (k, in, out)
            elif arr.ndim == 2:
                arr = arr.T
            _set_leaf(variables["params"], scopes + ["scale" if arr.ndim == 1 else "kernel"],
                      arr)
        else:
            raise ValueError(f"unknown state-dict key {key}")
    return _sorted_tree(variables)


def load_variables(path: Path | str) -> dict:
    """Untyped load of a flax msgpack checkpoint: nested dict of numpy."""
    return unpackb(Path(path).read_bytes())


def save_variables(variables: dict, path: Path | str) -> None:
    """Write a flax {"params", "batch_stats"} tree of numpy leaves."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(packb(variables))


def save_orcai_model(
    model_dir: Path | str,
    orcai_parameter: dict,
    state_dict: dict,
    input_shape=(736, 171, 1),
    opt_state: dict | None = None,
    train_state: dict | None = None,
) -> None:
    """Write a model directory from a torch state dict; `opt_state` (an
    optimizer's state_dict) goes to <name>.opt.pt."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    name = orcai_parameter["name"]
    save_variables(to_flax_variables(state_dict), model_dir / f"{name}.msgpack")
    write_json(orcai_parameter, model_dir / "orcai_parameter.json")
    write_json(
        {"input_shape": list(input_shape), "num_labels": len(orcai_parameter["calls"])},
        model_dir / "model_shape.json",
    )
    if opt_state is not None:
        torch.save(opt_state, model_dir / f"{name}.opt.pt")
    if train_state is not None:
        write_json(train_state, model_dir / "train_state.json")


def load_orcai_model(
    model_dir: Path | str | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
):
    """Load (model on `device`, orcai_parameter, shape).

    The weights are `<name>.msgpack`, else a reference `<name>.keras`
    archive, else a reference `model_weights.h5`, in that order. `dtype` is
    the CRNN compute dtype; the parameters stay float32.
    """
    dev = resolve_device(device)
    model_dir = Path(model_dir) if model_dir is not None else DEFAULT_MODEL_DIR
    orcai_parameter = read_json(model_dir / "orcai_parameter.json")
    shape = read_json(model_dir / "model_shape.json")
    name = orcai_parameter["name"]
    msgpack_path = model_dir / f"{name}.msgpack"
    keras_path = model_dir / f"{name}.keras"
    legacy_h5_path = model_dir / "model_weights.h5"
    if msgpack_path.exists():
        variables = load_variables(msgpack_path)
    elif keras_path.exists():
        variables = load_keras_checkpoint(keras_path, orcai_parameter,
                                          tuple(shape["input_shape"]))
    elif legacy_h5_path.exists():
        variables = load_keras_weights_h5(legacy_h5_path, orcai_parameter,
                                          tuple(shape["input_shape"]))
    else:
        raise ValueError(
            f"Couldn't find model weights ({name}.msgpack, {name}.keras or "
            f"model_weights.h5) in {model_dir}"
        )
    model = build_model(orcai_parameter, shape["input_shape"], dtype=dtype)
    state = convert_flax_variables(variables)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.to(dev).eval(), orcai_parameter, shape


_ADAM_HYPERPARAMS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def load_optax_adam_state(path: Path | str, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer) -> float:
    """Load optax's inject_hyperparams(adam) state from <name>.opt.msgpack
    into `optimizer`, trainer.make_optimizer(model)'s torch.optim.Adam;
    returns the restored learning rate.

    mu and nu are parameter trees in flax's layout; they take the weights'
    transposes (convert_flax_variables) and become exp_avg and exp_avg_sq,
    and Adam's count becomes every parameter's step. Parameters the model
    freezes are not in the optimizer and their moments are dropped.
    """
    tree = unpackb(Path(path).read_bytes())
    hyper = tree["hyperparams"]
    for name, want in _ADAM_HYPERPARAMS.items():
        if name in hyper and not np.isclose(float(hyper[name]), want, rtol=1e-6, atol=0):
            raise ValueError(f"{path}: optax adam {name}={float(hyper[name])}, the port's "
                             f"Adam has {want}")
    adam = tree["inner_state"]["0"]
    mu = convert_flax_variables({"params": adam["mu"]})
    nu = convert_flax_variables({"params": adam["nu"]})
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state = {}
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    for i, (name, param) in enumerate(trainable):
        if name not in mu:
            raise ValueError(f"{path}: no Adam moments for {name}")
        if mu[name].shape != tuple(param.shape):
            raise ValueError(f"{path}: Adam moments of {name} have shape {mu[name].shape}, "
                             f"the parameter {tuple(param.shape)}")
        state[i] = {
            "step": step.clone(),
            "exp_avg": torch.from_numpy(mu[name]).to(param),
            "exp_avg_sq": torch.from_numpy(nu[name]).to(param),
        }
    saved = optimizer.state_dict()
    saved["state"] = state
    saved["param_groups"][0]["lr"] = float(np.asarray(hyper["learning_rate"]))
    optimizer.load_state_dict(saved)
    return saved["param_groups"][0]["lr"]
