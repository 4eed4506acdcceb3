"""The port's documents name only what exists: every dotted
``bluest_tpu_torch.*`` name in backticks in docs/torch/API.md resolves by
import and ``getattr``, and so does every ``BLUEProblem`` method named
there (``BLUEProblem.name``, or a call ``name(...)`` in the BLUEProblem
section)."""

import importlib
import os
import re

import pytest
import torch

from bluest_tpu_torch import BLUEProblem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API = os.path.join(ROOT, "docs", "torch", "API.md")
DOCS = ("API.md", "MIGRATION.md", "DESIGN.md")


def spans(text):
    """Inline code spans, which may wrap a line (fenced blocks left
    out)."""
    text = re.sub(r"```.*?```", "", text, flags=re.S)
    return re.findall(r"`([^`]+)`", text)


def dotted_names(text):
    return sorted({m.group(0) for s in spans(text) for m in re.finditer(
        r"\bbluest_tpu_torch(?:\.[A-Za-z_]\w*)+", s)})


def resolve(name):
    """Import the longest module prefix of ``name``, getattr the rest."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(name)


def problem_methods(text):
    names = {m.group(1) for s in spans(text)
             for m in re.finditer(r"\bBLUEProblem\.(\w+)", s)}
    section = re.search(r"^## `BLUEProblem`$(.*?)^## ", text,
                        flags=re.S | re.M).group(1)
    names |= {m.group(1) for s in spans(section)
              for m in re.finditer(r"^(\w+)\(", s)}
    return sorted(names - {"BLUEProblem"})


def test_api_names_every_section():
    with open(API) as f:
        text = f.read()
    for section in ("## `BLUEProblem`", "## `SAP` / `MOSAP`",
                    "## `blue_fn` (host sampling engine)",
                    "## Parallelism (`bluest_tpu_torch.parallel`)",
                    "## Models (`bluest_tpu_torch.models`)",
                    "## Names kept for callers, and what they do"):
        assert section in text, section
    assert len(dotted_names(text)) >= 30
    assert len(problem_methods(text)) >= 30


@pytest.mark.parametrize("doc", DOCS)
def test_dotted_names_resolve(doc):
    with open(os.path.join(ROOT, "docs", "torch", doc)) as f:
        names = dotted_names(f.read())
    missing = []
    for name in names:
        try:
            resolve(name)
        except (ImportError, AttributeError):
            missing.append(name)
    assert not missing, missing


def test_problem_methods_resolve():
    with open(API) as f:
        names = problem_methods(f.read())
    missing = [n for n in names if not callable(getattr(BLUEProblem, n,
                                                        None))]
    assert not missing, missing
