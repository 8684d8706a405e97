"""2D inference CLI (the GTA5 -> Cityscapes path) on the card.

The port's counterpart of ``values_tpu/inference/test_2d.py`` (:37-309;
reference: uncertainty_modeling/test_2D.py:26-336). It reads the same
checkpoints (the JAX package's native pickle or a reference ``.ckpt`` of
an HRNet), the same preprocessed GTA/Cityscapes tree and the same flags,
and writes the same ``<save_dir>/<exp_name>/test_results/<version>/
<split>/`` tree:

    python -m values_tpu_torch.inference.test_2d \\
        --checkpoint_paths ckpt1 [ckpt2 ...] --test_split ood \\
        [-tta] [--n_pred N] [--sliding_window PH PW] \\
        [--dtype float32|bfloat16|float64] [--device cpu]

- the datamodule is rebuilt from the checkpoint's hparams with
  ``n_reference_samples`` patched into the test-time
  StochasticLabelSwitches (:99-129); its host streams (python ``random``
  and numpy) are seeded as the JAX tester seeds them, so the batches are
  byte-equal to its batches;
- C1: an SSN checkpoint gives ``--n_pred`` samples of its low-rank
  normal; ``-tta`` the dataset's 4 variants (hflip outputs un-flipped);
  otherwise ``--n_pred`` passes of each checkpoint (an ensemble when
  several are given; MC dropout with a ``DROPOUT_FINAL`` model);
  ``--sliding_window`` runs each image through
  :class:`~values_tpu_torch.inference.window2d.SlidingPredictor2D`;
- one ``torch.Generator`` on the device, seeded with the checkpoint's
  seed, draws every dropout mask and SSN normal (the JAX tester's
  ``self.rng``; the streams differ, ROADMAP.md R2);
- for all images of a batch at once, on the device: the label maps of
  the mean and of each prediction, with the ignored reference pixels
  moved to the class count (outside the softmax classes; the JAX tester
  appends a zero "extra class" channel instead); from those labels the
  mean Dice against the switched reference masks and GED
  (``ged_only``); PE/EE/MI, or 1 - MSR for a single prediction
  (:186-248); the colour maps;
- only the written maps and the metrics are copied back, in one blocking
  read a batch through pinned memory: colour PNGs (the mean and each
  prediction, ignore pixels black), float32 TIFs of each uncertainty
  map, ``metrics.json`` per image and their mean; the host then writes
  each image's files in turn.

``--device`` defaults to ``cuda``. The model runs in ``--dtype``
(bfloat16: bf16 compute, float32 softmax and statistics); an SSN refuses
bfloat16 and ``--sliding_window``, as the JAX tester does. On the card
the convolutions run channels-last, and in float32 under cuDNN's TF32,
PyTorch's default (``torch.backends.cudnn.allow_tf32``), as the
reference's PyTorch code did; matrix products stay float32
(``torch.backends.cuda.matmul.allow_tf32`` defaults off). There a
deterministic eval pass (softmax ensembles, ``--n_pred`` passes of a model
without DROPOUT_FINAL, ``-tta``, either type) replays a CUDA graph of its
model captured on its first batch (:class:`GraphedPass`), which takes the
host's per-op dispatch off the path; MC dropout, the SSN and
``--sliding_window`` run eagerly, as does every pass on the CPU. On the
card an SSN's samples and their softmax come from the hand-written
kernels of ``ops/kernels/ssn_sample.py`` (float32 or float64).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..config import instantiate, make_config
from ..core import tracing
from ..core.device import resolve_device
from ..core.image_io import write_png_rgb, write_tiff_float32
from ..core.seed import set_seed
from ..data import cityscapes_labels as cs_labels
from ..models.hrnet import HighResolutionNet
from ..models.torch_import import strip_model_prefix
from ..ops import metrics as ops_metrics
from ..ops import uncertainty as ops_uncertainty
from ..training.checkpoint import load_any_checkpoint
from .test_3d import DTYPES, test_cli
from .window2d import SlidingPredictor2D


def _color_table() -> np.ndarray:
    """(256, 3) uint8 RGB of each train id; ids without a colour black."""
    table = np.zeros((256, 3), dtype=np.uint8)
    for train_id, color in cs_labels.trainId2color.items():
        if 0 <= train_id < 256:
            table[train_id] = color
    return table


class GraphedPass:
    """A softmax pass captured as one CUDA graph on its first input and
    replayed on every later input of the same shape, type and strides.

    The capture follows PyTorch's recipe: a static input, eager warm-up
    passes on a side stream (cuDNN picks its algorithms and workspaces),
    then the capture on that stream into a private memory pool. It skips
    the ``gc.collect`` and ``empty_cache`` that ``torch.cuda.graph`` runs
    before each capture: they cost set-up time a member, and no memory
    needs freeing first.
    A replay copies the input in and returns a clone of the static
    output, so that every pass's softmax is a tensor of its own that the
    next replay cannot overwrite. The pass must not draw random numbers
    or read back to the host."""

    WARMUP = 2

    @torch.inference_mode()
    def __init__(self, fn, x: torch.Tensor):
        self.static_in = torch.empty_like(x)
        self.static_in.copy_(x)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                fn(self.static_in)
            self.graph.capture_begin()
            try:
                self.static_out = fn(self.static_in)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(x.device).wait_stream(side)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out.clone()


class Tester2D:
    def __init__(self, args):
        self.device = resolve_device(args.device)
        self.checkpoints = [load_any_checkpoint(p)
                            for p in args.checkpoint_paths]
        hparams = dict(self.checkpoints[0][0])
        if "MODEL" in hparams:  # pretrained weights would need a download
            hparams["MODEL"] = dict(hparams["MODEL"])
            hparams["MODEL"]["PRETRAINED"] = False
        self.hparams = hparams
        set_seed(hparams["seed"])
        self.ignore_index = hparams["datamodule"]["ignore_index"]
        self.tta = args.tta
        self.n_pred = args.n_pred
        self.test_split = args.test_split
        self.test_dataloader = self._get_test_dataloader(args, hparams)
        self.dtype = DTYPES[args.dtype]
        self.models = [self._load_model(hp, state)
                       for hp, state in self.checkpoints]
        self.is_ssn = self.models[0].ssn
        if self.is_ssn and self.dtype == torch.bfloat16:
            raise ValueError("--dtype bfloat16 is not supported for SSN "
                             "models (the low-rank-MVN head needs f32; "
                             "use float32)")
        self.results_dict: Dict[str, Dict] = {}
        self.generator = torch.Generator(self.device).manual_seed(
            int(hparams["seed"]))
        self.sliding_window = args.sliding_window
        self.sliding_overlap = args.sliding_overlap
        if self.sliding_window is not None and self.is_ssn:
            raise ValueError("--sliding_window is not supported for SSN "
                             "models (distribution sampling needs the "
                             "whole-image covariance)")
        self._sliding: Dict[int, SlidingPredictor2D] = {}
        self._colors = torch.from_numpy(_color_table()).to(self.device)

        save_root = args.save_dir or hparams["save_dir"]
        exp_name = args.exp_name or hparams["exp_name"]
        self.save_dir = os.path.join(save_root, exp_name, "test_results",
                                     str(hparams["version"]),
                                     args.test_split)
        self.save_pred_dir = os.path.join(self.save_dir, "pred_seg")
        os.makedirs(self.save_pred_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _load_model(self, hparams: Dict, state: Dict) -> HighResolutionNet:
        """The checkpoint's HRNet in eval mode on the device, in the
        run's type, built on the meta device and given the checkpoint's
        tensors (no random init of weights that are then replaced)."""
        with torch.device("meta"):
            model = instantiate(make_config(dict(hparams["model"])))
        if not isinstance(model, HighResolutionNet):
            raise ValueError(
                f"test_2d takes HRNet checkpoints; this one's model is "
                f"{hparams['model'].get('_target_')}: run "
                "values_tpu_torch.inference.test_3d")
        model.load_state_dict(strip_model_prefix(state), assign=True)
        model = model.eval().to(device=self.device, dtype=self.dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    @staticmethod
    def set_n_reference_samples(hparams: Dict, n_reference_samples: int):
        transforms = hparams["AUGMENTATIONS"]["TEST"][0]["Compose"][
            "transforms"]
        for aug in transforms:
            if "StochasticLabelSwitches" in aug:
                node = aug["StochasticLabelSwitches"] or {}
                node["n_reference_samples"] = n_reference_samples
                aug["StochasticLabelSwitches"] = node
        return hparams

    def _get_test_dataloader(self, args, hparams):
        data_input_dir = args.data_input_dir or hparams["data_input_dir"]
        if args.data_input_dir is not None:
            ds = hparams["datamodule"]["dataset"]
            ds["splits_path"] = ds["splits_path"].replace(
                hparams["data_input_dir"], args.data_input_dir)
        hparams = self.set_n_reference_samples(hparams,
                                               args.n_reference_samples)
        if args.test_batch_size:
            hparams["datamodule"]["val_batch_size"] = args.test_batch_size
        dm = instantiate(make_config(dict(hparams["datamodule"],
                                          _recursive_=False)),
                         data_input_dir=data_input_dir,
                         augmentations=hparams["AUGMENTATIONS"],
                         seed=hparams["seed"], test_split=args.test_split,
                         tta=self.tta)
        dm.setup("test")
        return dm.test_dataloader()

    # ------------------------------------------------------------------
    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W, C) host images -> (B, C, H, W) on the device, in the
        run's type (channels-last memory on the card)."""
        with tracing.span("test2d.to_device"):
            x = tracing.to_device(
                torch.from_numpy(np.ascontiguousarray(images)), self.device)
            x = x.permute(0, 3, 1, 2).to(self.dtype)
            if self.device.type == "cuda":
                return x.contiguous(memory_format=torch.channels_last)
            return x.contiguous()

    def _takes_graph(self, model: HighResolutionNet,
                     device: torch.device) -> bool:
        """Whether a pass replays a captured CUDA graph: a deterministic
        eval pass over the whole image on the card. The CPU, MC dropout
        and the SSN (which draw from the generator), the sliding window
        and training run eagerly."""
        return (device.type == "cuda" and not model.training
                and not model.dropout_final and not model.ssn
                and self.sliding_window is None)

    def _softmax(self, model: HighResolutionNet,
                 x: torch.Tensor) -> torch.Tensor:
        """The eager softmax pass: float32 for a bfloat16 model, else the
        model's type."""
        logits = model(x, generator=self.generator)
        if logits.dtype == torch.bfloat16:  # softmax/statistics stay f32
            logits = logits.to(torch.float32)
        return torch.softmax(logits, dim=1)

    def _forward(self, model: HighResolutionNet,
                 x: torch.Tensor) -> torch.Tensor:
        """One softmax pass over a batch, (B, C, H, W): float32 for a
        bfloat16 model, else the model's type. A DROPOUT_FINAL model draws
        its masks from the generator on every pass -- that IS the 2D MC
        dropout. Where :meth:`_takes_graph` allows, the pass replays the
        graph captured on the first batch of its model, shape, type and
        strides (a smaller last batch gets its own)."""
        tracing.count("forwards")
        if self._takes_graph(model, x.device):
            # made on first use, not in __init__: a subclass may replace it
            graphs = self.__dict__.setdefault("_graphs", {})
            key = (id(model), tuple(x.shape), x.dtype, x.stride())
            graph = graphs.get(key)
            if graph is None:
                graph = graphs[key] = GraphedPass(
                    lambda t: self._softmax(model, t), x)
            tracing.count("graphed_forwards")
            return graph(x)
        if self.sliding_window is not None:
            sp = self._sliding.get(id(model))
            if sp is None:
                sp = SlidingPredictor2D(model, self.sliding_window,
                                        model.num_classes,
                                        overlap=self.sliding_overlap)
                self._sliding[id(model)] = sp
            return torch.stack([sp(x[i], self.generator)
                                for i in range(x.shape[0])])
        return self._softmax(model, x)

    @torch.inference_mode()
    def predict_cases(self) -> None:
        for batch in self.test_dataloader:
            with tracing.span("test2d.batch"):
                preds: List[torch.Tensor] = []
                for model in self.models:
                    if self.is_ssn:
                        x = self._to_device(batch["data"])
                        # one trunk pass gives the low-rank normal; its
                        # n_pred samples are drawn after it
                        with tracing.span("test2d.forward"):
                            tracing.count("forwards")
                            dist = model(x)
                        with tracing.span("test2d.ssn_sample"):
                            b, _, h, w = x.shape
                            tracing.count("ssn_samples", self.n_pred * b)
                            preds.extend(dist.sample_softmax(
                                self.generator, self.n_pred,
                                (model.num_classes, h, w)))
                    elif self.tta:
                        # B items x 4 variants; each variant runs as a
                        # batch and hflip outputs are un-flipped
                        # (test_2D.py:296-311)
                        per_item = batch["data"]
                        for v, names in enumerate(batch["transforms"][0]):
                            x = self._to_device(
                                np.stack([item[v] for item in per_item]))
                            with tracing.span("test2d.forward"):
                                out = self._forward(model, x)
                                if "HorizontalFlip" in names:
                                    out = torch.flip(out, dims=(-1,))
                            preds.append(out)
                    else:
                        x = self._to_device(batch["data"])
                        for _ in range(self.n_pred):
                            with tracing.span("test2d.forward"):
                                preds.append(self._forward(model, x))
                with tracing.span("test2d.process_output"):
                    self.process_output({
                        "softmax_pred": torch.stack(preds),  # (S, B, C, H, W)
                        "image_id": batch["image_id"],
                        "gt": np.asarray(batch["seg"]),
                        "dataset": batch["dataset"],
                    }, is_ssn=self.is_ssn)
        self.save_results_dict()

    # ------------------------------------------------------------------
    @staticmethod
    def calculate_test_metrics(mean_softmax: torch.Tensor,
                               ground_truth: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        """One image's mean Dice over its raters, in the JAX tester's
        extra-class form: ``mean_softmax`` (C + 1, H, W) with a zero last
        channel, ``ground_truth`` (R, H, W) with C on the ignored pixels.
        :meth:`process_output` takes it for a whole batch from labels
        (``ops/metrics.py::label_test_metrics``)."""
        ignore = mean_softmax.shape[0] - 1
        dices = [ops_metrics.dice_score(mean_softmax[None], rater[None],
                                        ignore_index=ignore)
                 for rater in ground_truth]
        return {"dice": torch.stack(dices).mean()}

    def process_output(self, all_preds: Dict, is_ssn: bool) -> None:
        """A batch's metrics and maps from its (S, B, C, H, W) softmax
        stack (any strides): taken for all B images at once on the device,
        read back in one copy, then each image's ``results_dict`` entry and
        files on the host, in the image's turn."""
        softmax = all_preds["softmax_pred"]
        s, b, c, h, w = softmax.shape
        tracing.count("images", b)
        gt = tracing.to_device(torch.from_numpy(all_preds["gt"]),
                               self.device).long()
        if gt.ndim == 3:  # a single reference mask -> a rater axis
            gt = gt[:, None]
        ignore_map = gt == self.ignore_index
        # the ignored pixels as class c, which no argmax over c classes gives
        gt = gt.masked_fill(ignore_map, c)
        with tracing.span("test2d.metrics"):
            samples = torch.argmax(softmax, dim=2)  # (S, B, H, W)
            # (K, B, H, W): the mean's and each prediction's, or the one's
            labels = (torch.cat([torch.argmax(torch.mean(softmax, dim=0),
                                              dim=1)[None], samples])
                      if s > 1 else samples)
            metrics = ops_metrics.label_test_metrics(
                labels[0].flatten(1), samples.transpose(0, 1).flatten(2),
                gt.flatten(2), ignore_index=c)
            # rater 0's ignored pixels unlabeled; (B, K, H, W, 3) RGB
            colors = self._colors[labels.masked_fill(
                ignore_map[:, 0], cs_labels.name2trainId["unlabeled"]
            ).transpose(0, 1)]
        with tracing.span("test2d.uncertainty"):
            stack = softmax.transpose(1, 2)  # (S, C, B, H, W)
            if s > 1:
                unc = ops_uncertainty.uncertainty_measures(stack, ssn=is_ssn)
            else:
                unc = ops_uncertainty.one_minus_msr(stack[0])
            maps = torch.stack([v.to(torch.float32) for v in unc.values()])
        colors, maps, metrics = tracing.to_host_packed(
            [colors, maps, torch.stack(list(metrics.values()), dim=1)])
        colors, maps = colors.numpy(), maps.numpy()
        for image_idx, image_id in enumerate(all_preds["image_id"]):
            self.results_dict[image_id] = {
                "dataset": all_preds["dataset"][image_idx],
                "metrics": dict(zip(("dice", "ged"),
                                    metrics[image_idx].tolist()))}
            self.save_prediction(image_id, colors[image_idx])
            self.save_uncertainty(image_id,
                                  dict(zip(unc, maps[:, image_idx])))

    # ------------------------------------------------------------------
    def save_prediction(self, image_id: str, colors: np.ndarray) -> None:
        """One image's (K, H, W, 3) RGB label maps, host arrays: the
        mean's and each prediction's, or the one prediction's."""
        with tracing.span("test2d.save_prediction"):
            multiple = colors.shape[0] > 1
            with tracing.span("test2d.write"):
                for output_idx, color in enumerate(colors):
                    idx = output_idx if multiple else output_idx + 1
                    img_name = (f"{image_id}_mean" if idx == 0 and multiple
                                else f"{image_id}_{idx:02d}")
                    write_png_rgb(os.path.join(self.save_pred_dir,
                                               f"{img_name}.png"), color)

    def save_uncertainty(self, image_id: str,
                         uncertainty_dict: Dict[str, np.ndarray]) -> None:
        """One image's float32 (H, W) uncertainty maps, host arrays."""
        with tracing.span("test2d.save_uncertainty"):
            with tracing.span("test2d.write"):
                for unc_type, unc_map in uncertainty_dict.items():
                    unc_dir = os.path.join(self.save_dir, unc_type)
                    os.makedirs(unc_dir, exist_ok=True)
                    write_tiff_float32(
                        os.path.join(unc_dir, f"{image_id}.tif"), unc_map)

    def save_results_dict(self) -> None:
        mean_metrics: Dict[str, List[float]] = {}
        for value in self.results_dict.values():
            for metric, score in value["metrics"].items():
                mean_metrics.setdefault(metric, []).append(score)
        self.results_dict["mean"] = {"metrics": {
            metric: float(np.mean(scores))
            for metric, scores in mean_metrics.items()}}
        with open(os.path.join(self.save_dir, "metrics.json"), "w") as f:
            json.dump(self.results_dict, f, indent=2)


def run_test(args) -> Tester2D:
    tester = Tester2D(args)
    tester.predict_cases()
    return tester


def main(argv=None) -> Tester2D:
    with tracing.profiled():
        return run_test(test_cli(argv, description=__doc__))


if __name__ == "__main__":
    main()
