"""Loaders for the vendored example programs (repo `examples/` dir).

The examples are the reference's own target workloads
(`upstream:examples/`, SURVEY.md §2.7): simple_token and token are the
BASELINE.json config-3/5 proof benchmarks.
"""

from __future__ import annotations

import os
from typing import Dict

from .interpreter import Registry
from .parser import Program, parse_program

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples",
)


def load_example(name: str) -> Registry:
    """Parse examples/<name>/main.aleo (+ imports/) into a Registry."""
    root = os.path.join(EXAMPLES_DIR, name)
    reg = Registry()
    imports_dir = os.path.join(root, "imports")
    if os.path.isdir(imports_dir):
        for fn in sorted(os.listdir(imports_dir)):
            if fn.endswith(".aleo"):
                with open(os.path.join(imports_dir, fn)) as f:
                    reg.add(parse_program(f.read()))
    with open(os.path.join(root, "main.aleo")) as f:
        reg.add(parse_program(f.read()))
    return reg


def load_program(name: str) -> Program:
    with open(os.path.join(EXAMPLES_DIR, name, "main.aleo")) as f:
        return parse_program(f.read())
