"""Sectioned parameter-file configuration system (a copy of
``mlmcpathintegral_tpu/utils/config.py``, which the port does not import).

Reference parity: src/common/parameters.{hh,cc} — files consist of
``section:`` headers followed by ``key = value  # comment`` lines; values
are integers, floats, bools (true/false) or (optionally quoted) strings.
Reference ``parameters_qm_template.in`` / ``parameters_qft_template.in``
files parse unchanged.

The parsed result is a plain dict-of-dicts with typed accessors; driver
code reads sections through :class:`Section`, which also applies the
reference's numeric-constraint checks (Positive / NonNegative).
"""

from __future__ import annotations

import re
from pathlib import Path

_SECTION_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(#.*)?$")
_KEYVAL_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.*?)\s*(#.*)?$")


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith(("'", '"')) and raw.endswith(("'", '"')) \
            and len(raw) >= 2:
        return raw[1:-1]
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def read_parameter_file(path) -> dict:
    """Parse a reference-style ``.in`` file into {section: {key: value}}."""
    sections: dict = {}
    current = None
    for lineno, line in enumerate(
            Path(path).read_text().splitlines(), start=1):
        stripped = line.split("#", 1)[0].strip()
        if not stripped:
            continue
        m = _SECTION_RE.match(line)
        if m:
            current = m.group(1)
            sections.setdefault(current, {})
            continue
        m = _KEYVAL_RE.match(line)
        if m:
            if current is None:
                raise ValueError(
                    f"{path}:{lineno}: key-value pair outside any section")
            sections[current][m.group(1)] = _parse_value(m.group(2))
            continue
        raise ValueError(f"{path}:{lineno}: cannot parse line: {line!r}")
    return sections


class Section:
    """Typed, constraint-checked view of one config section
    (the analog of the per-subsystem XYZParameters classes)."""

    def __init__(self, config: dict, name: str, defaults: dict | None = None):
        self.name = name
        self._data = dict(defaults or {})
        self._data.update(config.get(name, {}))

    def _get(self, key, typ):
        if key not in self._data:
            raise KeyError(f"section '{self.name}': missing key '{key}'")
        val = self._data[key]
        if typ is float and isinstance(val, int):
            val = float(val)
        if not isinstance(val, typ) or (typ is not bool
                                        and isinstance(val, bool)):
            raise TypeError(
                f"section '{self.name}': key '{key}' = {val!r} is not "
                f"of type {typ.__name__}")
        return val

    def get_int(self, key, positive=False, non_negative=False) -> int:
        v = self._get(key, int)
        if positive and v <= 0:
            raise ValueError(f"{self.name}.{key} must be positive, got {v}")
        if non_negative and v < 0:
            raise ValueError(
                f"{self.name}.{key} must be non-negative, got {v}")
        return v

    def get_float(self, key, positive=False) -> float:
        v = self._get(key, float)
        if positive and v <= 0:
            raise ValueError(f"{self.name}.{key} must be positive, got {v}")
        return v

    def get_bool(self, key) -> bool:
        return self._get(key, bool)

    def get_string(self, key, choices=None) -> str:
        v = self._get(key, str)
        if choices is not None and v not in choices:
            raise ValueError(
                f"{self.name}.{key} = '{v}' not in {sorted(choices)}")
        return v
