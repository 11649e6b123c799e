"""Prometheus text-exposition lint (format 0.0.4) for ``/metrics``.

The rules ``promtool check metrics`` enforces, as the JAX package's
``tests/test_promlint.py`` states them, kept here so that a run on the
card (``chip_smoke.py``) can hold a live scrape to them with no test
harness:

* every sample belongs to a family announced by ``# HELP`` then
  ``# TYPE`` lines that precede it, each once, with a legal name, a
  non-empty help text and a known type;
* sample names match the legal charset and sample values parse;
* a histogram's ``le`` buckets are cumulative, ascending and end at
  ``+Inf``, and it carries one ``_sum`` and one ``_count`` equal to the
  ``+Inf`` bucket;
* the exposition ends with a newline.
"""

from __future__ import annotations

import re
from typing import Dict, List, Set, Tuple

__all__ = ["exposition_problems"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$"
)
_LE_RE = re.compile(r'^le="([^"]+)"$')


def _base_family(sample_name: str) -> str:
    # Histogram samples reference their family via the suffixed names.
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


def exposition_problems(text: str) -> List[str]:
    """Every rule ``text`` breaks, one message each (empty when clean)."""
    problems: List[str] = []
    if not text.endswith("\n"):
        problems.append("exposition must end with a newline")
    helped: Set[str] = set()
    typed: Dict[str, str] = {}
    samples: List[Tuple[str, str, str, str]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) != 4 or not parts[3].strip():
                problems.append(f"line {lineno}: bad HELP")
                continue
            if not _NAME_RE.match(parts[2]):
                problems.append(f"line {lineno}: bad HELP name {parts[2]!r}")
            if parts[2] in helped:
                problems.append(f"line {lineno}: duplicate HELP {parts[2]}")
            helped.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                problems.append(f"line {lineno}: bad TYPE")
                continue
            name, mtype = parts[2], parts[3]
            if mtype not in ("counter", "gauge", "histogram"):
                problems.append(f"line {lineno}: unknown type {mtype!r}")
            if name not in helped:
                problems.append(f"line {lineno}: TYPE before HELP for {name}")
            if name in typed:
                problems.append(f"line {lineno}: duplicate TYPE {name}")
            typed[name] = mtype
            continue
        if line.startswith("#"):
            problems.append(f"line {lineno}: unknown comment {line!r}")
            continue
        match = _SAMPLE_RE.match(line)
        if not match:
            problems.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name = match.group("name")
        family = _base_family(name)
        if family not in typed:
            problems.append(f"line {lineno}: sample {name} has no TYPE")
        try:
            float(match.group("value"))
        except ValueError:
            problems.append(f"line {lineno}: value of {name} does not parse")
            continue
        samples.append((family, name, match.group("labels") or "", line))

    for family, mtype in typed.items():
        if mtype != "histogram":
            continue
        rows = [s for s in samples if s[0] == family]
        buckets = [s for s in rows if s[1] == family + "_bucket"]
        if not buckets:
            problems.append(f"histogram {family} has no buckets")
            continue
        les, counts = [], []
        for _, _, labels, line in buckets:
            m = _LE_RE.match(labels)
            if not m:
                problems.append(f"bucket without le label: {line}")
                continue
            les.append(m.group(1))
            counts.append(float(line.rsplit(" ", 1)[1]))
        if not les:
            continue
        if les[-1] != "+Inf":
            problems.append(f"{family} buckets must end at +Inf")
        try:
            values = [float("inf") if v == "+Inf" else float(v) for v in les]
        except ValueError:
            problems.append(f"{family} has an le that does not parse")
            continue
        if values != sorted(values):
            problems.append(f"{family} le not sorted")
        if counts != sorted(counts):
            problems.append(f"{family} buckets not cumulative")
        count_rows = [s for s in rows if s[1] == family + "_count"]
        sum_rows = [s for s in rows if s[1] == family + "_sum"]
        if len(count_rows) != 1 or len(sum_rows) != 1:
            problems.append(f"{family} needs one _sum and one _count")
        elif float(count_rows[0][3].rsplit(" ", 1)[1]) != counts[-1]:
            problems.append(f"{family} _count differs from its +Inf bucket")
    return problems
