"""``_target_``-driven object instantiation (the Hydra subset).

The port's copy of ``values_tpu/config/instantiate.py``. Configs and
checkpoints name their targets by the reference's import paths or by the
JAX package's (``configs/*.yaml``), so :data:`TARGET_ALIASES` maps both
onto their ``values_tpu_torch`` counterparts. The port never imports the
JAX package: a ``values_tpu.*`` or reference target with no counterpart
raises ``NotImplementedError``. :data:`PREFIX_ALIASES` maps whole
modules: every ``values_tpu.evaluation.*`` target, and the reference's
evaluation targets (GTA's loaders, ``evaluation.utils.gta``, and the
reporting layer, ``evaluation.visualization``, included), onto
``values_tpu_torch.evaluation.*``; a name that module does not hold
raises ``NotImplementedError`` too.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any, Dict

from .node import Config

_MODEL = "values_tpu_torch.models.unet3d.UNet3D"
_SSN = "values_tpu_torch.models.ssn_unet3d.SsnUNet3D"
_TOY = "values_tpu_torch.data.toy_datamodule.ToyDataModule3D"
_LIDC = "values_tpu_torch.data.lidc_datamodule.LidcIdriDataModule3D"
_LOGGING = "values_tpu_torch.training.tb_logging"
_OPTIM = "values_tpu_torch.training.optim"
_EVAL = "values_tpu_torch.evaluation"
_HRNET = "values_tpu_torch.models.hrnet.get_seg_model"
_BASE_DM = "values_tpu_torch.data.base_datamodule.BaseDataModule"
_CITYSCAPES = "values_tpu_torch.data.cityscapes_dataset.CityscapesDataset"

# reference or JAX-package import path -> values_tpu_torch import path
TARGET_ALIASES: Dict[str, str] = {
    "uncertainty_modeling.models.unet3D_module.UNet3D": _MODEL,
    "values_tpu.models.unet3d.UNet3D": _MODEL,
    "uncertainty_modeling.models.ssn_unet3D_module.SsnUNet3D": _SSN,
    "values_tpu.models.ssn_unet3d.SsnUNet3D": _SSN,
    "uncertainty_modeling.toy_datamodule_3D.ToyDataModule3D": _TOY,
    "values_tpu.data.toy_datamodule.ToyDataModule3D": _TOY,
    "uncertainty_modeling.lidc_idri_datamodule_3D.LidcIdriDataModule3D":
        _LIDC,
    "values_tpu.data.lidc_datamodule.LidcIdriDataModule3D": _LIDC,
    "uncertainty_modeling.models.hrnet_module.get_seg_model": _HRNET,
    "values_tpu.models.hrnet.get_seg_model": _HRNET,
    "uncertainty_modeling.data.torch_dataloader.BaseDataModule": _BASE_DM,
    "values_tpu.data.base_datamodule.BaseDataModule": _BASE_DM,
    "uncertainty_modeling.data.cityscapes_dataset.CityscapesDataset":
        _CITYSCAPES,
    "values_tpu.data.cityscapes_dataset.CityscapesDataset": _CITYSCAPES,
    "pytorch_lightning.loggers.TensorBoardLogger":
        f"{_LOGGING}.TensorBoardLogger",
    "values_tpu.training.tb_logging.TensorBoardLogger":
        f"{_LOGGING}.TensorBoardLogger",
    "pytorch_lightning.callbacks.TQDMProgressBar": f"{_LOGGING}.ProgressBar",
    "values_tpu.training.tb_logging.ProgressBar": f"{_LOGGING}.ProgressBar",
}
for _torch_name, _name in (("SGD", "sgd"), ("Adam", "adam"),
                           ("RMSprop", "rmsprop"),
                           ("lr_scheduler.PolynomialLR", "polynomial_lr"),
                           ("lr_scheduler.ReduceLROnPlateau",
                            "reduce_lr_on_plateau")):
    TARGET_ALIASES[f"torch.optim.{_torch_name}"] = f"{_OPTIM}.{_name}"
    TARGET_ALIASES[f"values_tpu.training.optim.{_name}"] = f"{_OPTIM}.{_name}"
# module prefixes -> values_tpu_torch module prefixes: the JAX package's
# evaluation modules, and the reference's that the JAX package aliases
PREFIX_ALIASES: Dict[str, str] = {
    "values_tpu.evaluation.": f"{_EVAL}.",
    "evaluation.uncertainty_aggregation.": f"{_EVAL}.",
    "evaluation.metrics.": f"{_EVAL}.metrics.",
    "evaluation.utils.gta.": f"{_EVAL}.gta.",
    "evaluation.visualization.": f"{_EVAL}.visualization.",
    "evaluation.split_file_generation.split_files_second_cycle.":
        f"{_EVAL}.split_file_generation.second_cycle.",
    "evaluation.split_file_generation.split_files_second_cycle_random.":
        f"{_EVAL}.split_file_generation.second_cycle_random.",
}


def _not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(f"{path} has no counterpart in "
                               "values_tpu_torch")


def _import(path: str) -> Any:
    """The object at a dotted path, or None where nothing is there."""
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj: Any = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    return None


def locate(path: str) -> Any:
    """Import a dotted path after :data:`TARGET_ALIASES` and
    :data:`PREFIX_ALIASES`; raise ``NotImplementedError`` for a target the
    port has no counterpart of."""
    path = TARGET_ALIASES.get(path, path)
    prefix = next((p for p in PREFIX_ALIASES if path.startswith(p)), None)
    if prefix is not None:
        obj = _import(PREFIX_ALIASES[prefix] + path[len(prefix):])
        if obj is None:
            raise _not_ported(path)
        return obj
    if path.startswith(("values_tpu.", "uncertainty_modeling.",
                        "evaluation.")):
        raise _not_ported(path)
    obj = _import(path)
    if obj is None:
        raise ImportError(f"Could not locate '{path}'")
    return obj


def instantiate(node: Any, *args: Any, **kwargs: Any) -> Any:
    """Instantiate a config node carrying ``_target_``: ``_partial_``
    gives a ``functools.partial``, nested ``_target_`` nodes are built
    first (hydra.utils defaults)."""
    if node is None:
        return None
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return {k: instantiate(v) for k, v in node.items()}

    node = dict(node)
    target = node.pop("_target_")
    partial = bool(node.pop("_partial_", False))
    recursive = bool(node.pop("_recursive_", True))
    node.pop("_convert_", None)

    fn = locate(str(target))
    call_kwargs = {}
    for key, val in node.items():
        if recursive and isinstance(val, dict) and "_target_" in val:
            call_kwargs[key] = instantiate(val)
        elif isinstance(val, Config):
            call_kwargs[key] = val.to_container()
        elif isinstance(val, list):
            call_kwargs[key] = [
                v.to_container() if isinstance(v, Config) else v for v in val
            ]
        else:
            call_kwargs[key] = val
    call_kwargs.update(kwargs)
    if partial:
        return functools.partial(fn, *args, **call_kwargs)
    return fn(*args, **call_kwargs)
