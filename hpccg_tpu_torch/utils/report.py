"""Structured run report (ref YAML_Element.{hpp,cpp} + YAML_Doc.{hpp,cpp}).

A copy of ``hpccg_tpu.utils.report``, which is framework-free but cannot be
imported from the port (importing ``hpccg_tpu`` imports jax). A tree of
key/value nodes rendered as the reference's 2-space-indented YAML
(YAML_Element.cpp:86-93); also exports JSON. Like YAML_Doc::generateYAML
(YAML_Doc.cpp:40-71), write() saves ``<name>-<version>_<timestamp>.yaml``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Union

Value = Union[str, int, float]


def _fmt(v: Value) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"  # C++ ostream default: 6 significant digits
    return str(v)


class _Element:
    """One report node (ref YAML_Element: key, value, children)."""

    def __init__(self, key: str = "", value: Value = ""):
        self.key = key
        self.value = value
        self.children: Dict[str, "_Element"] = {}

    def add(self, key: str, value: Value = "") -> "_Element":
        el = _Element(key, value)
        self.children[key] = el
        return el

    def get(self, key: str) -> "_Element":
        # ref YAML_Element::get creates on miss (YAML_Element.cpp:72-79)
        if key not in self.children:
            return self.add(key, "")
        return self.children[key]

    def render(self, indent: int = 0) -> str:
        out = []
        if self.key:
            out.append(" " * indent + f"{self.key}: {_fmt(self.value)}")
            indent += 2
        for child in self.children.values():
            out.append(child.render(indent))
        return "\n".join(out)

    def to_obj(self):
        if not self.children:
            return self.value
        obj = {k: c.to_obj() for k, c in self.children.items()}
        if self.value != "":
            obj["_value"] = self.value
        return obj


class Report(_Element):
    """Top-level document (ref YAML_Doc)."""

    def __init__(self, name: str = "hpccg", version: str = "1.0"):
        super().__init__("", "")
        self.name = name
        self.version = version
        self.add("Mini-Application Name", name)
        self.add("Mini-Application Version", version)

    def generate_yaml(self) -> str:
        return self.render() + "\n"

    def to_json(self) -> str:
        return json.dumps(self.to_obj(), indent=2, default=str)

    def write(self, directory: str = ".", *, fmt: str = "yaml") -> str:
        stamp = time.strftime("%Y.%m.%d.%H.%M.%S")
        path = f"{directory}/{self.name}-{self.version}_{stamp}.{fmt}"
        with open(path, "w") as f:
            f.write(self.generate_yaml() if fmt == "yaml" else self.to_json())
        return path
