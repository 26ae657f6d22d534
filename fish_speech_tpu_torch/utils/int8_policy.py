"""Whether the port serves with int8 weights by default, decided by
fixed criteria.

Counterpart of `fish_speech_tpu/utils/int8_policy.py`, with the same
pre-registered criteria (constants, so that changing one shows as such
in a diff):

    teacher-forced token agreement >= 99% (`utils/quality.py::
        teacher_forced_agreement`: both parameter sets score the same
        bf16-generated sequence and their argmaxes are compared per
        position; the free-running number is evidence only, since one
        flipped argmax changes every later frame),
    mel-L1 <= 3x the bf16-vs-float32 vocoder floor,
    PCM SNR > 15 dB.

`evaluate()` applies them, `record_decision()` writes a proxy run to the
port's own decision file, and `serving_default_int8()` reads it. Only a
passing run on real weights turns the default to int8; a failing one on
real weights turns it back; runs on random weights add evidence only. A
missing file means bf16. The JAX package's decision file holds TPU runs
and is never read here.

The record carries `CRITERIA_VERSION`, as does each run it holds. A
default set under other criteria is not carried over: a file of another
version, or of none (written before the version existed), reads as bf16,
and the next run recorded starts its default afresh. The 99% bar is a
teacher-forced one (the JAX package moved it there from free-running
agreement without re-deriving it); changing a criterion means a new
version.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

DECISION_FILE = Path(__file__).resolve().parents[1] / "int8_decision.json"

CRITERIA_VERSION = 1  # of the criteria below; records of another version are not compared

MIN_TOKEN_AGREEMENT = 0.99
MAX_MEL_L1_VS_FLOOR = 3.0
MIN_SNR_DB = 15.0


def evaluate(token_agreement: float, mel_l1: float, mel_floor: float, snr_db: float) -> bool:
    """True iff the proxy passes every criterion."""
    return bool(
        token_agreement >= MIN_TOKEN_AGREEMENT
        and mel_l1 <= MAX_MEL_L1_VS_FLOOR * max(mel_floor, 1e-6)
        and snr_db > MIN_SNR_DB
    )


def criteria_dict() -> Dict[str, float]:
    return {
        "min_token_agreement": MIN_TOKEN_AGREEMENT,
        "max_mel_l1_vs_floor": MAX_MEL_L1_VS_FLOOR,
        "min_snr_db": MIN_SNR_DB,
    }


def read_decision(path: Optional[Path] = None) -> Optional[dict]:
    try:
        with open(path or DECISION_FILE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def current_version(decision: Optional[dict]) -> bool:
    """Whether a record was written under these criteria."""
    return bool(decision) and decision.get("criteria_version") == CRITERIA_VERSION


def record_decision(metrics: Dict[str, float], passed: bool, *, real_weights: bool,
                    evidence: str, path: Optional[Path] = None) -> dict:
    """Append a proxy run (the last 8 are kept, each with its criteria
    version) and, on real weights only, set the default: int8 if it
    passed, bf16 if not. A record of another criteria version keeps its
    runs as history but not its default, which starts again at bf16."""
    path = path or DECISION_FILE
    decision = dict(read_decision(path) or {"default": "bf16"})
    if not current_version(decision):
        decision["default"] = "bf16"
        decision.pop("decided_on_real_weights", None)
    decision["criteria"] = criteria_dict()
    decision["criteria_version"] = CRITERIA_VERSION
    runs = list(decision.get("runs", []))
    runs.append({
        "metrics": {k: round(float(v), 5) for k, v in metrics.items()},
        "passed": bool(passed),
        "real_weights": bool(real_weights),
        "evidence": evidence,
        "criteria_version": CRITERIA_VERSION,
    })
    decision["runs"] = runs[-8:]
    if real_weights:
        decision["default"] = "int8" if passed else "bf16"
        decision["decided_on_real_weights"] = True
    with open(path, "w") as f:
        json.dump(decision, f, indent=1, sort_keys=True)
        f.write("\n")
    return decision


def serving_default_int8(path: Optional[Path] = None) -> bool:
    """The serving default when the operator forces neither dtype;
    FISH_TPU_INT8 = 0/1 (or false/no) overrides the file, whose default
    counts only under the current criteria version."""
    env = os.environ.get("FISH_TPU_INT8")
    if env is not None and env != "":
        return env not in ("0", "false", "no")
    d = read_decision(path)
    return current_version(d) and d.get("default") == "int8"
