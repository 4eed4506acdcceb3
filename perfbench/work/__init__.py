"""The yardstick's arithmetic: operations and bytes of a model
evaluation, counted from its shapes, and the card's published peaks
(``peaks.json``).  ``work/<family>.py`` gives, for one configuration,
the least time the card needs for a list of (group, samples)."""

from __future__ import annotations

import functools
import json
import os


@functools.lru_cache(maxsize=1)
def peaks() -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        return json.load(f)
