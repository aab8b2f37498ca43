"""Verbosity-gated console report with section timing.

Counterpart of orcai_tpu/utils/messenger.py, with its levels, indentation
and marks: 4 verbosity levels (0 errors, 1 warnings, 2 info, 3 debug), a
start banner with the version and time, bold section headers with the
total and the delta wall time, and the platform, device, memory and size
reports. Without click, psutil or humanize: styles are ANSI codes written
only to a terminal (click.echo drops them elsewhere), the device report
reads torch.cuda, the resident memory /proc/self/statm, and sizes take
humanize's decimal units. Tables (io/tables.py::Table) print in pandas'
to_string layout, dicts through the package's JSON encoder.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from datetime import datetime, timedelta
from pathlib import Path

from orcai_tpu_torch.io.jsonio import JsonEncoderExt

ERROR, WARNING, INFO, DEBUG = 0, 1, 2, 3

# click.style's codes, in its order (colour, then bold, then italic)
_COLOURS = {"red": 31, "green": 32, "yellow": 33}


def _styled(text: str, fg: str | None = None, bold: bool = False,
            italic: bool = False) -> str:
    codes = ([f"\033[{_COLOURS[fg]}m"] if fg else []) + (["\033[1m"] if bold else []) + (
        ["\033[3m"] if italic else [])
    return "".join(codes) + text + "\033[0m" if codes else text


def naturalsize(size: float) -> str:
    """humanize.naturalsize(size, format="%.2f"): decimal units."""
    if abs(size) == 1:
        return f"{int(size)} Byte"
    if abs(size) < 1000:
        return f"{int(size)} Bytes"
    units = (" kB", " MB", " GB", " TB", " PB", " EB", " ZB", " YB", " RB", " QB")
    exp = int(min(math.log(abs(size), 1000), len(units)))
    return "%.2f" % (size / 1000**exp) + units[exp - 1]


def resident_bytes() -> int:
    """This process's resident set size, from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE")


class Messenger:
    """Prints messages gated by verbosity with indent tracking and part timers."""

    def __init__(
        self,
        title: str | None = None,
        n_indent: int = 0,
        verbosity: int = 2,
        indent_str: str = "    ",
        show_part_times: bool = True,
        file=None,
    ):
        self.n_indent = n_indent
        self.verbosity = verbosity
        self.indent_str = indent_str
        self.show_part_times = show_part_times
        self.file = file
        self._t0 = time.time()
        self._last_part: float | None = None
        if title is not None:
            self.start(title)

    # -- core ---------------------------------------------------------------

    def _indented(self, lines) -> str:
        return "\n".join(self.indent_str * self.n_indent + str(line) for line in lines)

    def _fmt(self, message) -> str:
        if hasattr(message, "to_string"):  # a Table or a grouped count
            return self._indented(message.to_string().splitlines())
        if isinstance(message, dict):
            return self._indented(
                json.dumps(message, indent=4, cls=JsonEncoderExt).splitlines())
        if isinstance(message, (list, tuple)):
            return self._indented(message)
        return str(message)

    def print(
        self,
        message,
        indent: int = 0,
        set_indent: int | None = None,
        prepend: str = "",
        severity: int = INFO,
        **style,
    ):
        if self.verbosity < severity:
            return
        if set_indent is not None:
            self.n_indent = set_indent
        if isinstance(message, str):
            text = self.indent_str * self.n_indent + prepend + message
        else:
            # _fmt already applies the indentation; only insert the severity
            # marker after the first line's pad
            text = self._fmt(message)
            if prepend:
                pad = self.indent_str * self.n_indent
                if text.startswith(pad):
                    text = pad + prepend + text[len(pad):]
                else:
                    text = prepend + text
        out = self.file if self.file is not None else sys.stdout
        if style and out.isatty():
            text = _styled(text, **style)
        out.write(text + "\n")
        out.flush()
        self.n_indent += indent

    # -- levels ---------------------------------------------------------------

    def debug(self, message, indent=0, set_indent=None, severity=DEBUG, **kw):
        self.print(message, indent, set_indent, severity=severity, **kw)

    def info(self, message, indent=0, set_indent=None, severity=INFO, **kw):
        self.print(message, indent, set_indent, severity=severity, **kw)

    def warning(self, message, indent=0, set_indent=None, severity=WARNING, **kw):
        self.print(message, indent, set_indent, prepend="‼️ ", severity=severity,
                   fg="yellow", **kw)

    def error(self, message, indent=0, set_indent=None, severity=ERROR, **kw):
        self.print(message, indent, set_indent, prepend="❌ ", severity=severity,
                   fg="red", **kw)

    # -- sections -------------------------------------------------------------

    def start(self, message, indent=0, set_indent=0, severity=INFO, **kw):
        self.print(message, indent, set_indent, prepend="🐳 ", severity=severity,
                   bold=True, **kw)
        if self.verbosity >= severity:
            from orcai_tpu_torch import __version__

            self.print(
                f"orcAI-TPU {__version__} "
                f"[started @ {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}]",
                indent, set_indent, severity=severity, italic=True, **kw,
            )

    def part(self, message, indent=1, set_indent=0, severity=INFO, **kw):
        now = time.time()
        if self.show_part_times:
            total = timedelta(seconds=round(now - self._t0))
            delta = (
                f", 𝚫 {timedelta(seconds=round(now - self._last_part))}"
                if self._last_part is not None
                else ""
            )
            message = f"{message} [{total}{delta}]"
        self._last_part = now
        self.print(message, indent, set_indent, prepend="🐳 ", severity=severity,
                   bold=True, **kw)

    def success(self, message, indent=0, set_indent=0, severity=INFO, **kw):
        self.part(message, indent, set_indent, severity=severity, fg="green", **kw)

    # -- reports ----------------------------------------------------------------

    def print_platform_info(self, severity=INFO, **kw):
        if self.verbosity < severity:
            return
        import platform

        import torch

        self.info(f"Platform: {platform.platform()}", severity=severity, italic=True, **kw)
        self.info(f"Python version: {sys.version}", severity=severity, italic=True, **kw)
        self.info(f"PyTorch version: {torch.__version__}", severity=severity, italic=True,
                  **kw)

    def print_device_info(self, indent=0, set_indent=None, severity=INFO, **kw):
        if self.verbosity < severity:
            return
        import torch

        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            desc = ", ".join(
                f"{i}: {torch.cuda.get_device_name(i)} "
                f"({naturalsize(torch.cuda.get_device_properties(i).total_memory)})"
                for i in range(n))
            text = f"PyTorch backend: cuda {torch.version.cuda} ({n} devices) [{desc}]"
        else:
            text = "PyTorch backend: cpu (no CUDA device)"
        self.info(text, indent=indent, set_indent=set_indent, severity=severity, italic=True,
                  **kw)

    def print_memory_usage(self, indent=0, set_indent=None, severity=INFO, **kw):
        if self.verbosity < severity:
            return
        self.info(f"memory usage: {naturalsize(resident_bytes())}", indent=indent,
                  set_indent=set_indent, severity=severity, italic=True, **kw)

    def print_file_size(self, file: Path, indent=0, set_indent=None, severity=INFO, **kw):
        if self.verbosity < severity:
            return
        size = Path(file).stat().st_size
        self.info(f"Size on disk of {Path(file).name}: {naturalsize(size)}",
                  indent=indent, set_indent=set_indent, severity=severity, **kw)

    def print_directory_size(self, directory: Path, indent=0, set_indent=None,
                             severity=INFO, **kw):
        if self.verbosity < severity:
            return
        total = sum(f.stat().st_size for f in Path(directory).rglob("*") if f.is_file())
        self.info(f"Size on disk of {Path(directory).stem}: {naturalsize(total)}",
                  indent=indent, set_indent=set_indent, severity=severity, **kw)
