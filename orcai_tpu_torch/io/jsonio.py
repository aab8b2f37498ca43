"""JSON file reading (counterpart of orcai_tpu/io/jsonio.py, read side)."""

from __future__ import annotations

import json
from pathlib import Path


def read_json(filename: Path | str) -> dict:
    with open(filename, "r") as f:
        return json.load(f)
