"""Shared helpers for the filter steps."""

from __future__ import annotations

from typing import List

__all__ = ["rust_lines", "fmt2", "fmt4", "rust_bool", "rust_float"]


def rust_lines(text: str) -> List[str]:
    """Split like Rust's ``str::lines()``: on ``\\n``, stripping one trailing
    ``\\r`` per line, with no trailing empty line for newline-terminated text.

    (Python's ``splitlines()`` also breaks on ``\\x0b``/``\\x85``/U+2028 etc.,
    which would diverge from the reference.)
    """
    if not text:
        return []
    parts = text.split("\n")
    if parts and parts[-1] == "":
        parts.pop()
    return [p[:-1] if p.endswith("\r") else p for p in parts]


def fmt2(v: float) -> str:
    """Rust ``{:.2}`` formatting."""
    return f"{v:.2f}"


def fmt4(v: float) -> str:
    """Rust ``{:.4}`` formatting."""
    return f"{v:.4f}"


def rust_bool(b: bool) -> str:
    """Rust ``{}`` Display for bool."""
    return "true" if b else "false"


def rust_float(v: float) -> str:
    """Rust ``{}`` Display for f64: shortest round-trip decimal, with integral
    values printed without the trailing ``.0`` Python's repr adds."""
    s = repr(float(v))
    if s.endswith(".0"):
        return s[:-2]
    return s
