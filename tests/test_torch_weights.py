"""Port checkpoint reading: msgpack_lite vs flax, and the flax -> torch
weight conversion (orcai_tpu_torch/io)."""

import numpy as np
import pytest
import torch

import flax.serialization
import jax

from orcai_tpu.resources import MODELS_DATA_DIR
from orcai_tpu_torch.io.model_store import (
    DEFAULT_MODEL_DIR,
    convert_flax_variables,
    load_orcai_model,
    load_variables,
)
from orcai_tpu_torch.io.msgpack_lite import unpackb
from orcai_tpu_torch.models import build_model

MSGPACK = MODELS_DATA_DIR / "orcai-v1" / "orcai-v1.msgpack"


def setup_module():
    torch.set_num_threads(1)


def _flat(tree):
    return {
        jax.tree_util.keystr(path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def test_default_model_dir_is_the_bundled_one():
    assert DEFAULT_MODEL_DIR.resolve() == (MODELS_DATA_DIR / "orcai-v1").resolve()


def test_msgpack_lite_matches_flax_restore_bit_for_bit():
    raw = MSGPACK.read_bytes()
    ours = _flat(unpackb(raw))
    ref = _flat(flax.serialization.msgpack_restore(raw))
    assert ours.keys() == ref.keys() and len(ours) == 97
    for key, leaf in ref.items():
        got = ours[key]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, key
        assert got.tobytes() == leaf.tobytes(), key


def test_msgpack_lite_decodes_the_flax_subset():
    """Every msgpack form flax can emit for a state dict: fix/16/32 maps,
    str8 keys, ints of each width, floats, bools, None, bytes, lists,
    ndarray (ExtType 1) of several dtypes including 0-d and empty, and
    numpy scalars (ExtType 3)."""
    rng = np.random.default_rng(0)
    tree = {
        "ints": {"a": 1, "b": -3, "c": 200, "d": -200, "e": 70000,
                 "f": -70000, "g": 2**40, "h": -(2**40)},
        "floats": {"x": 0.5, "y": -1e300},
        "misc": {"t": True, "f": False, "n": None, "raw": b"\x00\xff" * 40,
                 "lst": [1, "two", 3.0]},
        "k" * 40: "v" * 300,
        "big": {f"leaf{i}": rng.standard_normal((3, 4)).astype(np.float32)
                for i in range(20)},
        "dtypes": {
            "f64": rng.standard_normal(7),
            "i8": np.arange(-5, 5, dtype=np.int8),
            "u16": np.arange(9, dtype=np.uint16).reshape(3, 3),
            "b": np.array([True, False]),
            "scalar0d": np.asarray(np.float32(2.5)),
            "empty": np.zeros((0, 3), np.float32),
            "npscalar": np.int64(-7),
            "wide": rng.standard_normal((300, 300)).astype(np.float32),
        },
    }
    raw = flax.serialization.msgpack_serialize(tree)
    ours = _flat(unpackb(raw))
    ref = _flat(flax.serialization.msgpack_restore(raw))
    assert ours.keys() == ref.keys()
    for key, leaf in ref.items():
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(leaf))
        assert np.asarray(ours[key]).dtype == np.asarray(leaf).dtype, key


@pytest.mark.parametrize(
    "bad", [b"\xc1", b"\x92\x01", b"\x01\x02", b"\xd4\x05\x00"]
)
def test_msgpack_lite_rejects_malformed_input(bad):
    with pytest.raises(ValueError):
        unpackb(bad)


def test_conversion_covers_every_leaf():
    variables = load_variables(MSGPACK)
    leaves = _flat(variables)
    state = convert_flax_variables(variables)
    n_lstm = sum(1 for k in leaves if "recurrent_kernel" in k)
    # one key per checkpoint leaf, plus one zero bias_hh per LSTM direction
    assert len(state) == len(leaves) + n_lstm
    param = {"architecture": "ResNetLSTM", "calls": list("ABCDEFG"),
             "model": {"filters": [30, 40, 50, 60], "kernel_size": 3,
                       "lstm_units": 128}}
    model = build_model(param)
    assert set(state) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})


def test_conversion_layouts():
    variables = load_variables(MSGPACK)
    state = convert_flax_variables(variables)
    p = variables["params"]
    np.testing.assert_array_equal(
        state["trunk.entry_conv.weight"],
        p["trunk"]["entry_conv"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        state["trunk.block1_sep2.depthwise.weight"][:, 0],
        p["trunk"]["block1_sep2"]["depthwise"]["kernel"][:, :, 0, :].transpose(2, 0, 1),
    )
    np.testing.assert_array_equal(state["dense.weight"], p["dense"]["kernel"].T)
    fwd = p["bilstm1"]["forward"]
    np.testing.assert_array_equal(state["bilstm1.fwd.weight_ih"], fwd["kernel"].T)
    np.testing.assert_array_equal(
        state["bilstm1.fwd.weight_hh"], fwd["recurrent_kernel"].T
    )
    np.testing.assert_array_equal(state["bilstm1.fwd.bias_ih"], fwd["bias"])
    assert not state["bilstm2.bwd.bias_hh"].any()
    np.testing.assert_array_equal(
        state["trunk.head_bn.running_var"],
        variables["batch_stats"]["trunk"]["head_bn"]["var"],
    )
    np.testing.assert_array_equal(
        state["dense_bn.weight"], p["dense_bn"]["scale"]
    )


def test_conversion_rejects_unknown_leaves():
    with pytest.raises(ValueError, match="unknown checkpoint leaf"):
        convert_flax_variables({"params": {"dense": {"gamma": np.ones(3)}}})
    with pytest.raises(ValueError, match="collections"):
        convert_flax_variables({"params": {}, "cache": {}})


def test_load_orcai_model_on_cpu():
    model, param, shape = load_orcai_model(device="cpu")
    assert not model.training
    assert param["name"] == "orcai-v1" and shape["input_shape"] == [736, 171, 1]
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in model.parameters())


def test_packb_round_trips_and_is_what_flax_reads():
    """The writer's subset: nested str-keyed maps, lists, scalars of every
    width, bytes, arrays of several dtypes and shapes."""
    import flax.serialization

    from orcai_tpu_torch.io.msgpack_lite import packb

    rng = np.random.default_rng(0)
    tree = {
        "params": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
                   "empty": np.zeros((0, 2), np.float32),
                   "scalar": np.full((), 2.5, np.float32),
                   "i": np.arange(300, dtype=np.int32), "d": rng.standard_normal(17)},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                 -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)],
        "floats": [0.0, -1.5, 1e300], "none": None, "flags": [True, False],
        "text": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 70000, "\u00e9"],
        "raw": b"\x00\x01" * 200,
        "wide": {f"k{i}": i for i in range(20)}, "long": list(range(70000)),
    }
    raw = packb(tree)
    back = unpackb(raw)

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b and type(a) is type(b)

    same(tree, back)
    same(tree, flax.serialization.msgpack_restore(raw))

    def by_key(t):  # flax walks a dict in key order
        return {k: by_key(v) if isinstance(v, dict) else v for k, v in sorted(t.items())}

    assert packb(by_key(tree)) == flax.serialization.msgpack_serialize(tree)
    for bad in ({1: 2}, object(), 2**64, -(2**63) - 1, np.array([object()])):
        with pytest.raises(ValueError):
            packb(bad)
