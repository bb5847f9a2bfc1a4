"""The FLOPs of one call, counted once a shape over the frozen reference and kept in the
benchmark's cache inside the checkout (``benchmark/.cache/flops/``)."""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable

from torch.utils.flop_counter import FlopCounterMode

from harness.common import CACHE_DIR


def count(fn: Callable[[], object]) -> int:
    """The FLOPs that ``FlopCounterMode`` counts over ``fn()``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def cached(key: dict, fn: Callable[[], object]) -> int:
    """``count(fn)`` for the shape that ``key`` names (a JSON object: the configuration,
    the batch, the clip length), counted on the first call and read after."""
    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:20]
    path = CACHE_DIR / "flops" / f"{digest}.json"
    try:
        return int(json.loads(path.read_text())["flops"])
    except (OSError, ValueError, KeyError):
        pass
    flops = count(fn)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"key": key, "flops": flops}))
    os.replace(tmp, path)
    return flops
