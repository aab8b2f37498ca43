"""The port stands alone: importing any of its modules loads none of jax,
flax, optax, orbax, pandas, zarr, msgpack, click, tqdm, humanize, psutil,
tensorflow, keras, h5py, google.protobuf or the JAX package, and no source
of the port (or chip_smoke.py) imports one of them."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "pandas", "zarr", "msgpack", "click", "tqdm",
             "humanize", "psutil", "tensorflow", "keras", "h5py", "google.protobuf",
             "orcai_tpu")
# torch itself loads tqdm where it is installed, so the subprocess check
# leaves tqdm and click to the source scan
NOT_LOADED = ("jax", "flax", "optax", "orbax", "pandas", "zarr", "msgpack", "humanize",
              "psutil", "tensorflow", "keras", "h5py", "google.protobuf", "orcai_tpu")
SOURCES = sorted((ROOT / "orcai_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# a package's __init__.py is imported as the package
MODULES = [
    ".".join(p.relative_to(ROOT).with_suffix("").parts[: -1 if p.name == "__init__.py" else None])
    for p in SOURCES
]


def test_every_module_of_the_slice_is_scanned():
    for name in ("ops.streaming", "pipeline.serve", "tools.warmup",
                 "utils.device_health", "pipeline.predict", "__main__",
                 "models.crnn", "models.layers", "io.model_store", "io.msgpack_lite",
                 "io.dataset", "io.jsonio", "utils.seeds", "ops.losses", "ops.overlap",
                 "train.trainer", "train.checkpoint", "train.evaluate", "resources",
                 "tools.profile_train", "io.blosc", "io.zarrlite", "io.tables",
                 "io.annotations", "io.wav", "utils.rle", "native", "pipeline.helpers",
                 "pipeline.spectrogram", "pipeline.labels", "pipeline.snippets",
                 "tools.synthetic", "tools.profile_data_prep", "ops.wire_names",
                 "ops.wire_codec", "ops.spectral", "tools.parity", "ops.dft",
                 "train.hpsearch", "tools.profile_first_epoch", "io.tfrecord",
                 "io.tfdata_convert", "io.hdf5", "io.keras_convert", "parallel",
                 "parallel.distributed", "parallel.mesh", "parallel.sharding_rules",
                 "utils.messenger", "tools.probe_grad_split"):
        assert f"orcai_tpu_torch.{name}" in MODULES
    assert "chip_smoke" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax_stack(module):
    # a subprocess: this pytest process already imported jax (conftest.py)
    code = (
        f"import json, sys, {module}\n"
        f"print(json.dumps(sorted(m for m in sys.modules "
        f"if any(m == n or m.startswith(n + '.') for n in {NOT_LOADED!r}))))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_forbidden(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):  # `from google import protobuf` too
            names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            for bad in FORBIDDEN:
                assert name != bad and not name.startswith(bad + "."), (
                    f"{path.name}:{node.lineno} imports {name}")
    text = path.read_text()
    assert "orcai_tpu." not in text.replace("orcai_tpu/", "")
    assert "from orcai_tpu " not in text
