"""Small filesystem helpers.

The port's own copy of ``values_tpu/core/io.py`` (``subfiles`` :15,
``load_pickle`` :35, ``save_pickle`` :40, ``load_json`` :60,
``save_json`` :65): ``save_json`` writes numpy scalars and arrays as JSON
numbers and lists.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import Any, List, Optional, Union

import numpy as np


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


def save_pickle(obj: Any, path: Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o: Any) -> Any:
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, Path):
            return str(o)
        return super().default(o)


def load_json(path: Union[str, Path]) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path: Union[str, Path], indent: int = 2) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, cls=_NumpyJSONEncoder)
