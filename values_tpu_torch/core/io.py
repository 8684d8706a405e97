"""Small filesystem helpers.

The port's own copy of what it uses of ``values_tpu/core/io.py``
(``load_pickle`` :35). The other helpers there (``subfiles``,
``save_pickle``, the JSON pair) come over with the slice that first
calls them.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Union


def load_pickle(path: Union[str, Path]) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
