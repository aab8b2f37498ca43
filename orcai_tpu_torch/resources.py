"""Package data locations: this package's own copies of the default
parameter files (counterpart of orcai_tpu/resources.py)."""

from pathlib import Path

DEFAULTS_DIR = Path(__file__).parent / "defaults"
DEFAULT_ORCAI_PARAMETER = DEFAULTS_DIR / "default_orcai_parameter.json"
DEFAULT_HPS_PARAMETER = DEFAULTS_DIR / "default_hps_parameter.json"
DEFAULT_CALL_DURATION_LIMITS = DEFAULTS_DIR / "default_call_duration_limits.json"
