"""Darknet `.cfg` front-end: INI-style sections of key=value options.

Behaviour-compatible with the reference reader (`parser.cpp:59-98
ReadSections` + `option_list.cpp ReadOption/FindOption`):

* a line starting with ``[`` opens a new section;
* blank lines and lines starting with ``#`` or ``;`` are comments;
* every other line must be ``key=value`` (whitespace is stripped everywhere,
  exactly like the reference's `strip()` which removes all spaces/tabs);
* within a section the *first* occurrence of a key wins (the reference
  appends to a linked list and `FindOption` scans front-to-back);
* unused keys are reported (`UnusedOption`, `option_list.cpp:232`) — here we
  track reads and expose `Section.unused()`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator


def _strip(line: str) -> str:
    """Remove ALL whitespace, like the reference's strip() (utils.cpp)."""
    return "".join(ch for ch in line if ch not in " \t\n\r")


@dataclasses.dataclass
class Section:
    """One `[type]` section with its key=value options and read-tracking."""

    type: str                       # includes brackets, e.g. "[convolutional]"
    options: dict                   # key -> raw string value (first occurrence)
    line: int = 0                   # 1-based cfg line for diagnostics
    _used: set = dataclasses.field(default_factory=set, repr=False)
    # 1-based cfg line per key, so UnusedOption diagnostics can point at
    # the offending line instead of the section header
    key_lines: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- typed lookups -----------------------------------------------------
    # The reference has loud (FindOptionInt: prints the default it used) and
    # quiet (FindOptionIntQuiet) variants; defaults behave identically so we
    # provide one accessor per type.

    def get_str(self, key: str, default: str | None = None) -> str | None:
        if key in self.options:
            self._used.add(key)
            return self.options[key]
        return default

    def get_int(self, key: str, default: int | None = None) -> int | None:
        v = self.get_str(key)
        if v is None:
            return default
        # atoi semantics: parse leading integer, ignore trailing junk.
        return int(float(v)) if ("." in v or "e" in v or "E" in v) else int(v)

    def get_float(self, key: str, default: float | None = None) -> float | None:
        v = self.get_str(key)
        if v is None:
            return default
        return float(v)

    def get_int_list(self, key: str) -> list[int] | None:
        v = self.get_str(key)
        if v is None:
            return None
        return [int(float(t)) for t in v.split(",") if t != ""]

    def get_float_list(self, key: str) -> list[float] | None:
        v = self.get_str(key)
        if v is None:
            return None
        return [float(t) for t in v.split(",") if t != ""]

    def unused(self) -> list[str]:
        """Keys present in the cfg but never read (UnusedOption warnings)."""
        return [k for k in self.options if k not in self._used]


def parse_cfg_text(text: str) -> list[Section]:
    sections: list[Section] = []
    current: Section | None = None
    for line_num, raw in enumerate(text.splitlines(), start=1):
        line = _strip(raw)
        if not line or line[0] in "#;":
            continue
        if line[0] == "[":
            current = Section(type=line, options={}, line=line_num)
            sections.append(current)
            continue
        if current is None:
            raise ValueError(f"cfg line {line_num}: option before any section")
        if "=" not in line:
            raise ValueError(f"cfg line {line_num}: could not parse: {raw!r}")
        key, _, value = line.partition("=")
        # first occurrence wins (reference list scan order)
        if key not in current.options:
            current.options[key] = value
            current.key_lines[key] = line_num
    return sections


def parse_cfg_file(path) -> list[Section]:
    with open(path, "r") as f:
        return parse_cfg_text(f.read())


def patch_cfg_dims(text: str, w: int, h: int) -> str:
    """Rewrite the [net] width=/height= lines of cfg TEXT for runtime
    resize / multi-scale rebuilds.  Whitespace-tolerant (the parser strips
    `width = 608` to `width=608`, so a bare `^width=` regex would silently
    miss it); raises if either line is absent rather than failing later
    with a shape error."""
    import re

    out, n_w = re.subn(r"(?m)^\s*width\s*=.*$", f"width={w}", text, count=1)
    out, n_h = re.subn(r"(?m)^\s*height\s*=.*$", f"height={h}", out, count=1)
    if n_w == 0 or n_h == 0:
        raise ValueError("cfg text has no width=/height= line to patch "
                         "for resize")
    return out


def iter_unused_warnings(sections: list[Section]) -> Iterator[str]:
    for s in sections:
        for key in s.unused():
            line = s.key_lines.get(key, s.line)
            yield f"Unused option in {s.type} (line {line}): {key}={s.options[key]}"
