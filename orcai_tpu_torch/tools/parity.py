"""Annotation-level parity of a coded wire against the exact wire.

Counterpart of orcai_tpu/tools/parity.py, copied as it is. A coded wire
(ops/wire_codec.py, ops/spectral.py) perturbs the audio; its contract is
stated at the level of annotations, not of numbers:

1. Every substantive annotation (duration >= SUBSTANTIVE_S) of the
   exact-wire output appears on the coded-wire output with the same label
   and both boundaries within BOUNDARY_ROWS aggregation rows, and the coded
   wire invents none: every residual (one-side-only) annotation is shorter
   than SUBSTANTIVE_S.
2. Residuals below SUBSTANTIVE_S ("flickers": detections at the decision
   threshold, which any perturbation flips) number at most
   MAX_FLICKERS_PER_HOUR per recording-hour.

The bounds are the reference's, calibrated there (about 1.5x over the 18
flickers per hour its 20-minute runs measured).
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

#: an annotation at least this long is "substantive": it must survive the
#: wire exactly (same label, boundaries within BOUNDARY_ROWS)
SUBSTANTIVE_S = 0.75
#: boundary tolerance, in aggregation rows (one row = 2**n_filters
#: spectrogram frames = 16 * 256 / 48000 s ~ 0.0853 s for orcai-v1)
BOUNDARY_ROWS = 2
#: sub-SUBSTANTIVE_S disagreements allowed per recording-hour
MAX_FLICKERS_PER_HOUR = 27.0


def row_seconds_for(orcai_parameter: dict) -> float:
    """One aggregation row in seconds for a model's actual geometry.

    2**n_filters spectrogram frames per output row (models/crnn.py) at
    hop/sr seconds per frame: the boundary tolerance for a model other than
    orcai-v1, whose row compare_annotations takes by default.
    """
    sp = orcai_parameter["spectrogram"]
    n_filters = len(orcai_parameter["model"]["filters"])
    return 2**n_filters * sp["n_overlap"] / sp["sampling_rate"]


def read_annotations(path: Path | str) -> list[tuple[float, float, str]]:
    """Rows of an Audacity label TSV (start, stop, label), header skipped."""
    out = []
    for line in Path(path).read_text().strip().splitlines()[1:]:
        s, e, lab = line.split("\t")
        out.append((float(s), float(e), lab))
    return out


def compare_annotations(
    coded: Path | str,
    exact: Path | str,
    row_seconds: float = 16 * 256 / 48000,
) -> dict:
    """Interval-aware diff of two Audacity TSVs (lossy-wire parity report).

    Classifies pairs as identical, boundary-shifted (same label,
    endpoints within BOUNDARY_ROWS aggregation rows), or residual —
    annotations present on only one side. Residuals on near-threshold
    noise are expected from any perturbation; the contract
    (check_wire_parity) bounds what they may be.
    """
    a, b = read_annotations(coded), read_annotations(exact)
    # multiset diff (not set): duplicate rows — two call runs rounding to
    # identical times — must not collapse, or the tallies would drop real
    # discrepancies and stop summing to the reported annotation counts
    ca, cb = Counter(a), Counter(b)
    identical = sum((ca & cb).values())
    ra = sorted((ca - cb).elements())
    rb = sorted((cb - ca).elements())
    tol = BOUNDARY_ROWS * row_seconds
    shifted = 0
    used: set[int] = set()
    rest_a = []
    for s0, e0, lab in ra:
        hit = None
        for j, (s1, e1, lab1) in enumerate(rb):
            if j in used or lab1 != lab:
                continue
            if abs(s0 - s1) <= tol and abs(e0 - e1) <= tol:
                hit = j
                break
        if hit is None:
            rest_a.append((s0, e0, lab))
        else:
            used.add(hit)
            shifted += 1
    rest_b = [r for j, r in enumerate(rb) if j not in used]
    residual_durs = sorted(e - s for s, e, _ in rest_a + rest_b)
    return {
        "annotations_coded": len(a),
        "annotations_exact": len(b),
        "identical": identical,
        "boundary_shifted_le_2rows": shifted,
        "residual_coded_only": len(rest_a),
        "residual_exact_only": len(rest_b),
        "residual_max_duration_s": round(max(residual_durs, default=0.0), 3),
        # per-residual durations so the contract can count true flickers
        # (sub-threshold residuals) separately from substantive losses;
        # rounded for the report, raw for the gate: a 0.7495 s residual
        # must not round up into the 0.75 s substantive class
        "residual_durations_s": [round(d, 3) for d in residual_durs],
        "residual_durations_raw_s": residual_durs,
    }


def check_wire_parity(
    parity: dict,
    recording_minutes: float,
    *,
    substantive_s: float = SUBSTANTIVE_S,
    max_flickers_per_hour: float = MAX_FLICKERS_PER_HOUR,
) -> dict:
    """Evaluate the enforced parity contract on a compare_annotations dict.

    Returns {"ok": bool, "violations": [str, ...], plus the evaluated
    bounds}; chip_smoke.py fails its run when ok is False.
    """
    violations: list[str] = []
    # gate on UNROUNDED durations when the dict carries them (new-style
    # compare_annotations output): the 3-decimal report rounding must not
    # promote a 0.7495 s residual into the substantive class or demote a
    # 0.7504 s one out of it
    raw_durs = parity.get("residual_durations_raw_s")
    max_dur = (
        max(raw_durs, default=0.0)
        if raw_durs is not None
        else parity["residual_max_duration_s"]
    )
    if max_dur >= substantive_s:
        violations.append(
            f"substantive annotation ({round(max_dur, 3)} s "
            f">= {substantive_s} s) lost or invented by the coded wire"
        )
    n_residuals = (
        parity["residual_coded_only"] + parity["residual_exact_only"]
    )
    # true flickers are only the SUB-threshold residuals; substantive
    # residuals are a different defect class (violation above) and must
    # not inflate the flicker metric the docs quote. Older parity dicts
    # without per-residual durations fall back to the total (every
    # residual counted — conservative).
    durs = raw_durs if raw_durs is not None else parity.get(
        "residual_durations_s"
    )
    flickers = (
        sum(1 for d in durs if d < substantive_s)
        if durs is not None
        else n_residuals
    )
    hours = recording_minutes / 60.0
    rate = flickers / hours if hours > 0 else float("inf")
    if rate > max_flickers_per_hour:
        violations.append(
            f"{flickers} sub-{substantive_s}s flicker disagreements in "
            f"{recording_minutes:g} min = {rate:.1f}/hr "
            f"> {max_flickers_per_hour}/hr"
        )
    return {
        "ok": not violations,
        "violations": violations,
        "flickers_per_hour": round(rate, 2),
        "max_flickers_per_hour": max_flickers_per_hour,
        "substantive_s": substantive_s,
    }
