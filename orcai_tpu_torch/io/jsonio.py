"""JSON file reading and writing, and the {min, max, length} form of an
equally spaced vector (counterpart of orcai_tpu/io/jsonio.py and
orcai_tpu/utils/jsonenc.py)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class JsonEncoderExt(json.JSONEncoder):
    """Paths as strings, numpy scalars and arrays as Python values."""

    def default(self, obj):
        if isinstance(obj, Path):
            return str(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def read_json(filename: Path | str) -> dict:
    with open(filename, "r") as f:
        return json.load(f)


def write_json(dictionary: dict, filename: Path | str) -> None:
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with open(filename, "w") as f:
        f.write(json.dumps(dictionary, indent=4, cls=JsonEncoderExt))


def write_vector_to_json(vector, filename: Path | str) -> None:
    """Store an equally spaced vector as {min, max, length}."""
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    payload = {"min": vector[0], "max": vector[-1], "length": len(vector)}
    with open(filename, "w") as f:
        json.dump(payload, f, indent=4, cls=JsonEncoderExt)


def generate_times_from_spectrogram(filename: Path | str) -> np.ndarray:
    """Rebuild the equally spaced vector from its {min, max, length}."""
    with open(filename, "r") as f:
        d = json.load(f)
    return np.linspace(d["min"], d["max"], d["length"])
