"""Tell a dead CUDA context from an exhausted one and from a bad input.

Counterpart of orcai_tpu/utils/backend_health.py for a CUDA device. A
long-lived service (pipeline/serve.py) has to tell three failures apart:

"input"          the recording is at fault (corrupt wav, too short, wrong
                 channel). Report it once and go on; a retry cannot succeed.
"out_of_memory"  `torch.cuda.OutOfMemoryError`: the allocation was refused,
                 nothing ran, and the device is sound. Dropping the
                 process's device state and building it again is worth one
                 retry.
"device_lost"    a sticky CUDA error: an illegal memory access, an
                 unspecified launch failure, a device-side assert, an
                 uncorrectable ECC error. The process's CUDA context is dead,
                 every later call returns the same error, and nothing
                 inside the process can bring it back: only a new process.

PyTorch raises the sticky family as a plain RuntimeError("CUDA error: ..."),
and the port's own kernel wrappers report a launch's error by its number
("CUDA error 700"), so classification is by message, kept narrow, over the
exception and its __cause__/__context__ chain. A sticky error anywhere in
the chain wins over an out-of-memory error beside it.
"""

from __future__ import annotations

import re

import torch

# cudaGetErrorString texts of the errors that leave the context unusable
_STICKY_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "uncorrectable ecc",
    "illegal instruction",
    "misaligned address",
    "hardware stack error",
)
# the same errors by number, as ops/dft.py and ops/radix_select.py report a
# refused launch: cudaErrorECCUncorrectable 214, IllegalAddress 700,
# HardwareStackError 714, IllegalInstruction 715, MisalignedAddress 716,
# LaunchFailure 719, Assert 710
_STICKY_CODES = re.compile(r"cuda error (214|700|710|714|715|716|719)\b")
_OOM_MARKER = "cuda out of memory"


def classify_error(exc: BaseException) -> str:
    """"input", "out_of_memory" or "device_lost" for an exception raised
    while predicting one recording (see the module docstring)."""
    kind = "input"
    seen: set[int] = set()
    e: BaseException | None = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        text = str(e).lower()
        if any(m in text for m in _STICKY_MARKERS) or _STICKY_CODES.search(text):
            return "device_lost"
        if isinstance(e, torch.cuda.OutOfMemoryError) or _OOM_MARKER in text:
            kind = "out_of_memory"
        e = e.__cause__ or e.__context__
    return kind
