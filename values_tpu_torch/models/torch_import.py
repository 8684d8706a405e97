"""Weight bridge: flax UNet3D variables -> reference state_dicts -> the
grouped ensemble weights of :mod:`values_tpu_torch.models.ensemble_unet3d`;
flax HRNet variables -> the state_dict of
:class:`values_tpu_torch.models.hrnet.HighResolutionNet`.

Counterpart of ``values_tpu/models/torch_import.py`` (``strip_model_prefix``
:48, ``unet3d_params_to_torch`` :173-245, ``export_reference_checkpoint``
:248, ``load_reference_checkpoint`` :258-274) and of
``values_tpu/models/ensemble_unet3d.py::group_member_variables`` (:187-230);
:func:`hrnet_params_to_torch` inverts ``hrnet_params_from_torch`` (:105-147),
which the port has too, with ``merge_pretrained_hrnet`` (:150-170).
The port keeps its own copies: it imports nothing of the JAX package.

Layouts:
- reference Conv3d weight (O, I, kd, kh, kw); the JAX package's DHWIO
  kernel (kd, kh, kw, I, O);
- reference ConvTranspose3d weight (I, O, kd, kh, kw); DHWIO (kd, kh, kw,
  I, O).

Grouped weights (:func:`group_member_state_dicts`) hold, per module name,
``{"kernel", "bias"}`` tensors in the JAX grouped layout: 3x3x3 and 1x1x1
kernels stack members on the output-channel axis, (k, k, k, Cin, M*Cout),
and the k2s2 transposed convs on a leading member axis, (M, 2, 2, 2, Cin,
Cout) with bias (M, Cout).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

_CENTER_MAP = {"0": "center_conv1", "2": "center_conv2", "4": "center_up"}
TRANSPOSED = ("center_up", "upscale4", "upscale3", "upscale2")

_BLOCK_RE = re.compile(r"^(contr_\d_\d|expand_\d_\d)\.0\.(weight|bias)$")
_CENTER_RE = re.compile(r"^center\.(\d)\.(weight|bias)$")
_PLAIN_RE = re.compile(r"^(final|final_aleatoric|mean_conv|log_cov_diag_conv|"
                       r"cov_factor_conv|upscale\d)\.(weight|bias)$")


def strip_model_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the Lightning ``model.`` key prefix of reference ``.ckpt``
    state_dicts."""
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in state_dict.items()}


_FLAX_PLAIN_RE = re.compile(
    r"^(final|final_aleatoric|output_reconstruction_map|mean_conv|"
    r"log_cov_diag_conv|cov_factor_conv|upscale\d)\.(weight|bias)$")


def unet3d_params_from_torch(state_dict: Mapping[str, Any],
                             dtype: Any = np.float32) -> Dict[str, Any]:
    """A (possibly ``model.``-prefixed) UNet3D state_dict -> the flax
    ``{"params": ...}`` variables of numpy arrays (the port's copy of
    ``values_tpu/models/torch_import.py::unet3d_params_from_torch``,
    :56-104): conv blocks under ``{"conv": {"kernel", "bias"}}``, kernels
    DHWIO."""
    params: Dict[str, Any] = {}
    for key, tensor in strip_model_prefix(state_dict).items():
        arr = (tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
               else np.asarray(tensor))
        block = _BLOCK_RE.match(key)
        m = block or _CENTER_RE.match(key) or _FLAX_PLAIN_RE.match(key)
        if not m:
            raise KeyError(f"Unrecognized UNet3D state_dict key: {key}")
        module, leaf = m.groups()
        module = _CENTER_MAP.get(module, module)
        if leaf == "weight":
            arr = np.transpose(arr, (2, 3, 4, 0, 1) if module in TRANSPOSED
                               else (2, 3, 4, 1, 0))
        node = params.setdefault(module, {})
        if block:
            node = node.setdefault("conv", {})
        node["kernel" if leaf == "weight" else "bias"] = arr.astype(dtype)
    return {"params": params}


def unet3d_params_to_torch(variables: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """flax UNet3D variables (nested dicts of numpy arrays) -> a
    reference-layout state_dict with ``model.``-prefixed keys. Heads the
    reference constructs but flax never materializes (``final`` beside
    ``final_aleatoric``; the SSN's unused ``final``, sized ``C*2 + C*R``;
    ``output_reconstruction_map``) are filled with zeros so a strict
    ``load_state_dict`` succeeds."""
    params = variables["params"] if "params" in variables else variables
    reverse_center = {v: k for k, v in _CENTER_MAP.items()}
    state: Dict[str, torch.Tensor] = {}

    def put(key, kernel, bias, transposed):
        perm = (3, 4, 0, 1, 2) if transposed else (4, 3, 0, 1, 2)
        state[f"model.{key}.weight"] = torch.tensor(
            np.transpose(np.asarray(kernel), perm))
        state[f"model.{key}.bias"] = torch.tensor(np.asarray(bias))

    for module, leaves in params.items():
        if "conv" in leaves:  # contr_* / expand_* blocks
            put(f"{module}.0", leaves["conv"]["kernel"],
                leaves["conv"]["bias"], False)
        elif module in reverse_center:
            put(f"center.{reverse_center[module]}", leaves["kernel"],
                leaves["bias"], module == "center_up")
        else:  # upscale* transposed convs and the 1x1x1 heads
            put(module, leaves["kernel"], leaves["bias"],
                module.startswith("upscale"))
    f = np.asarray(params["contr_1_1"]["conv"]["kernel"]).shape[-1]
    if "final_aleatoric" in params and "model.final.weight" not in state:
        c = np.asarray(params["final_aleatoric"]["kernel"]).shape[-1] // 2
        state["model.final.weight"] = torch.zeros(c, f, 1, 1, 1)
        state["model.final.bias"] = torch.zeros(c)
    if "mean_conv" in params and "model.final.weight" not in state:
        c = np.asarray(params["mean_conv"]["kernel"]).shape[-1]
        cr = np.asarray(params["cov_factor_conv"]["kernel"]).shape[-1]
        state["model.final.weight"] = torch.zeros(2 * c + cr, f, 1, 1, 1)
        state["model.final.bias"] = torch.zeros(2 * c + cr)
    if "model.output_reconstruction_map.weight" not in state:
        state["model.output_reconstruction_map.weight"] = torch.zeros(
            1, f, 1, 1, 1)
        state["model.output_reconstruction_map.bias"] = torch.zeros(1)
    return state


def is_hrnet_target(hparams: Any) -> bool:
    """Whether a checkpoint's ``hyper_parameters`` name an HRNet model
    (the reference's, the JAX package's or the port's target)."""
    try:
        target = str(hparams["model"].get("_target_", ""))
    except (KeyError, AttributeError, TypeError):
        target = ""
    return "hrnet" in target.lower()


def hrnet_params_to_torch(variables: Mapping[str, Any],
                          cfg: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax HRNet variables (``params`` and ``batch_stats`` of numpy
    arrays, the JAX package's tree) -> the port's HRNet state_dict, with
    ``model.``-prefixed keys, for the HRNet of config ``cfg``:

    - conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw), bias as is;
    - BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
      ``running_mean``/``running_var``, ``num_batches_tracked`` 0.

    The flax module names are the torch prefixes with '.' -> '_'; the map
    is built from the port model's own keys (``fuse_layers``,
    ``last_layer`` and ``cov_factor_conv`` hold underscores of their own,
    so the reverse rewrite is not mechanical). Raises KeyError for a
    missing or an unused leaf."""
    from .hrnet import HighResolutionNet
    with torch.device("meta"):
        keys = list(HighResolutionNet(cfg).state_dict())
    params = variables["params"] if "params" in variables else variables
    stats = variables.get("batch_stats", {})
    bn_prefixes = {k[:-len(".running_mean")] for k in keys
                   if k.endswith(".running_mean")}
    used = set()
    state: Dict[str, torch.Tensor] = {}
    for key in keys:
        prefix, leaf = key.rsplit(".", 1)
        name = prefix.replace(".", "_")
        if leaf == "num_batches_tracked":
            state[f"model.{key}"] = torch.tensor(0)
            continue
        if leaf in ("running_mean", "running_var"):
            tree, flax_leaf = stats, leaf[len("running_"):]
        elif prefix in bn_prefixes:
            tree, flax_leaf = params, {"weight": "scale"}.get(leaf, leaf)
        else:
            tree, flax_leaf = params, {"weight": "kernel"}.get(leaf, leaf)
        try:
            arr = np.asarray(tree[name][flax_leaf])
        except KeyError:
            raise KeyError(f"HRNet variables lack {name}/{flax_leaf} "
                           f"(for {key})") from None
        used.add((id(tree), name, flax_leaf))
        if flax_leaf == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))
        state[f"model.{key}"] = torch.from_numpy(np.array(arr, order="C"))
    unused = [f"{n}/{leaf}" for tree in (params, stats)
              for n, leaves in tree.items() for leaf in leaves
              if (id(tree), n, leaf) not in used]
    if unused:
        raise KeyError(f"HRNet variables hold leaves the model lacks: "
                       f"{unused[:5]}")
    return state


def hrnet_params_from_torch(state_dict: Mapping[str, Any],
                            dtype: Any = np.float32) -> Dict[str, Any]:
    """An HRNet state_dict (the port's module, the reference's, or the
    public ImageNet weights after the reference's key remap at
    hrnet_module.py:682-737; ``model.`` prefix optional) -> the flax
    ``{"params", "batch_stats"}`` variables of numpy arrays (the port's
    copy of ``values_tpu/models/torch_import.py::hrnet_params_from_torch``,
    :105-147; the inverse of :func:`hrnet_params_to_torch`): module names
    are the torch prefixes with '.' -> '_'; conv weight (O, I, kh, kw) ->
    kernel (kh, kw, I, O); BN weight/bias -> scale/bias, running
    mean/var -> ``batch_stats`` mean/var; ``num_batches_tracked`` is
    dropped."""
    state_dict = strip_model_prefix(state_dict)
    bn_prefixes = {k[:-len(".running_mean")] for k in state_dict
                   if k.endswith(".running_mean")}
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    bn_leaves = {"weight": (params, "scale"), "bias": (params, "bias"),
                 "running_mean": (batch_stats, "mean"),
                 "running_var": (batch_stats, "var")}
    for key, tensor in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        prefix, leaf = key.rsplit(".", 1)
        name = prefix.replace(".", "_")
        arr = (tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
               else np.asarray(tensor)).astype(dtype)
        if prefix in bn_prefixes:
            tree, flax_leaf = bn_leaves[leaf]
            tree.setdefault(name, {})[flax_leaf] = arr
        elif leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"Unexpected weight rank for {key}")
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                np.transpose(arr, (2, 3, 1, 0)))
        elif leaf == "bias":
            params.setdefault(name, {})["bias"] = arr
        else:
            raise KeyError(f"Unrecognized HRNet state_dict key: {key}")
    return {"params": params, "batch_stats": batch_stats}


def merge_pretrained_hrnet(variables: Dict[str, Any],
                           pretrained: Dict[str, Any]) -> Dict[str, Any]:
    """Merge converted pretrained weights into initialised variables with
    the reference's filtering (hrnet_module.py:703-737; the JAX package's
    :150-170): only leaves the model has, of the same shape, are taken;
    everything else stays initialised. Returns a new tree."""
    merged = {c: {m: dict(leaves) for m, leaves in tree.items()}
              for c, tree in variables.items()}
    for collection in ("params", "batch_stats"):
        tgt = merged.get(collection, {})
        for module, leaves in pretrained.get(collection, {}).items():
            if module not in tgt:
                continue
            for leaf, value in leaves.items():
                if leaf in tgt[module] and (
                        tuple(np.shape(tgt[module][leaf]))
                        == tuple(np.shape(value))):
                    tgt[module][leaf] = value
    return merged


def export_reference_checkpoint(path: str, variables: Mapping[str, Any],
                                hyper_parameters: Dict[str, Any]) -> None:
    """Write flax UNet3D ``variables`` as a reference-compatible
    Lightning-style ``.ckpt``: ``state_dict`` from
    :func:`unet3d_params_to_torch` and ``hyper_parameters``."""
    torch.save({"state_dict": unet3d_params_to_torch(variables),
                "hyper_parameters": hyper_parameters}, path)


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, Any],
                                         Dict[str, torch.Tensor]]:
    """Read a reference Lightning ``.ckpt`` (zip or legacy pickle), of
    the UNet3D family or HRNet; returns ``(hyper_parameters,
    state_dict)`` with ``model.``-prefixed keys."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hparams = ckpt["hyper_parameters"]
    if hasattr(hparams, "items"):
        hparams = {k: v for k, v in hparams.items()}
    state = {(k if k.startswith("model.") else "model." + k):
             torch.as_tensor(v) for k, v in ckpt["state_dict"].items()}
    return hparams, state


def _member_kernels(state: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """One reference state_dict -> {module: {kernel (DHWIO), bias}} under
    the JAX module names."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, value in strip_model_prefix(state).items():
        value = torch.as_tensor(value)
        m = _BLOCK_RE.match(key) or _PLAIN_RE.match(key)
        if m:
            module, leaf = m.groups()
        else:
            m = _CENTER_RE.match(key)
            if key.startswith("output_reconstruction_map."):
                continue  # the unused autoencoder head is not grouped
            if not m:
                raise KeyError(f"unrecognized UNet3D state_dict key: {key}")
            module, leaf = _CENTER_MAP[m.group(1)], m.group(2)
        if leaf == "weight":
            perm = ((2, 3, 4, 0, 1) if module in TRANSPOSED
                    else (2, 3, 4, 1, 0))
            out.setdefault(module, {})["kernel"] = value.permute(*perm)
        else:
            out.setdefault(module, {})["bias"] = value
    return out


def group_member_state_dicts(state_dicts: List[Mapping[str, Any]],
                             dtype: torch.dtype = torch.float32
                             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """M reference UNet3D state_dicts (``model.`` prefix optional) -> the
    grouped ensemble weights (layouts in the module docstring)."""
    members = [_member_kernels(s) for s in state_dicts]
    grouped: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in members[0]:
        kernels = [m[name]["kernel"] for m in members]
        biases = [m[name]["bias"] for m in members]
        if name in TRANSPOSED:
            kernel, bias = torch.stack(kernels), torch.stack(biases)
        else:
            kernel, bias = torch.cat(kernels, -1), torch.cat(biases, -1)
        grouped[name] = {"kernel": kernel.to(dtype).contiguous(),
                         "bias": bias.to(dtype).contiguous()}
    return grouped
