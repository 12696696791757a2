"""The run's last line, and the guard against the JAX package.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with a traced run's
``breakdown`` where there is one, and last the numbers compared, each with
its limit (``checks``). The same numbers end standard error.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "sdf_representation_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict], device: Dict,
         checks: List[Dict], breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(_finite(out))


def _finite(x):
    """Infinities as the largest double's neighbourhood, so the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return -1e308 if x < 0 else 1e308
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def print_checks(checks: List[Dict]) -> None:
    for c in checks:
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
