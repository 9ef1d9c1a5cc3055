"""Typed long-option parameter system.

Equivalent of the reference's macro-table flag parser (misc/params.h:119-180:
BEGIN_LONG_PARAMS / LONG_STRING_PARAM / LONG_INT_PARAM / LONG_DOUBLE_PARAM /
EXCLUSIVE_PARAM groups) including the parameter status block printed at
startup (paramList::Status).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Param:
    name: str
    type: type  # str, int, float, bool
    default: Any
    help: str = ""
    group: str = ""


@dataclass
class ParamList:
    """A typed flag table.  Flags are ``--name value`` (bools are bare)."""

    description: str = "Available Options"
    params: list[Param] = field(default_factory=list)
    values: dict[str, Any] = field(default_factory=dict)
    _group: str = ""

    def group(self, title: str, desc: str = "") -> None:
        self._group = title

    def add(self, name: str, default: Any, help: str = "", type_: type | None = None) -> None:
        t = type_ if type_ is not None else type(default)
        self.params.append(Param(name, t, default, help, self._group))
        self.values[name] = default

    def read(self, argv: list[str]) -> list[str]:
        """Parse argv; returns leftover positional args."""
        byname = {p.name: p for p in self.params}
        rest: list[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("--"):
                name = a[2:]
                if name not in byname:
                    raise SystemExit(f"Unknown option --{name}")
                p = byname[name]
                if p.type is bool:
                    self.values[name] = True
                    i += 1
                else:
                    if i + 1 >= len(argv):
                        raise SystemExit(f"Option --{name} requires a value")
                    raw = argv[i + 1]
                    self.values[name] = p.type(raw)
                    i += 2
            else:
                rest.append(a)
                i += 1
        return rest

    def status(self, out=sys.stderr) -> None:
        """Print the parameter status block (misc/params.h paramList::Status)."""
        print(f"\nDetected parameters in effect:", file=out)
        cur_group = None
        for p in self.params:
            if p.group != cur_group:
                cur_group = p.group
                print(f"\n== {cur_group} ==", file=out)
            val = self.values[p.name]
            mark = "" if val == p.default else "  [changed]"
            print(f"  --{p.name:<24} {val}{mark}", file=out)
        print("", file=out)

    def __getitem__(self, name: str) -> Any:
        return self.values[name]
