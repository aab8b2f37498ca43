"""Wire-codec names, with no dependency, so the command line can list them
without importing torch (counterpart of orcai_tpu/ops/wire_names.py).
ops/wire_codec.py re-exports WIRE_CODECS for the numeric callers."""

WIRE_CODECS = (
    "exact", "mulaw8", "bfp6", "bfp5", "sp-bfp6", "sp-bfp5", "sp11-bfp5"
)
