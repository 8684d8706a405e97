"""Small filesystem helpers.

The port's own copy of what it uses of ``values_tpu/core/io.py``
(``subfiles`` :15, ``load_pickle`` :35). The JSON helpers come over with
the slice that first calls them.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Any, List, Optional, Union


def subfiles(folder: Union[str, Path], join: bool = True,
             prefix: Optional[str] = None, suffix: Optional[str] = None,
             sort: bool = True) -> List[str]:
    """List plain files in ``folder`` filtered by prefix/suffix."""
    folder = str(folder)
    res = [os.path.join(folder, f) if join else f
           for f in os.listdir(folder)
           if os.path.isfile(os.path.join(folder, f))
           and (prefix is None or f.startswith(prefix))
           and (suffix is None or f.endswith(suffix))]
    if sort:
        res.sort()
    return res


def load_pickle(path: Union[str, Path]) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
