"""The port stands alone: importing its predict path loads none of jax,
flax, pandas, msgpack or the JAX package, and no source of the port (or
chip_smoke.py) imports the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "pandas", "msgpack", "orcai_tpu")
SOURCES = sorted((ROOT / "orcai_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "module", ["orcai_tpu_torch.pipeline.predict", "orcai_tpu_torch.__main__"]
)
def test_import_loads_no_jax_stack(module):
    # a subprocess: this pytest process already imported jax (conftest.py)
    code = (
        f"import json, sys, {module}\n"
        f"print(json.dumps(sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})))"
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
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in FORBIDDEN, f"{path.name}:{node.lineno} imports {root}"
    text = path.read_text()
    assert "orcai_tpu." not in text.replace("orcai_tpu/", "")
    assert "from orcai_tpu " not in text
