"""Active-learning cycle orchestration.

The port's counterpart of ``values_tpu/evaluation/al_driver.py``
(:31-145). The reference writes the second-cycle split files but trains
the second cycle out of band; this driver closes the loop:

1. uncertainty-query split generation for every (uncertainty,
   aggregation) of an evaluated experiment
   (``split_file_generation``) plus the random-acquisition baselines,
2. one training run per splits file, through the port's
   ``training.loops.fit`` on ``device`` (default: the CUDA card, K1
   forward and K1b backward), composed from a training config with
   ``datamodule.splits_path`` pointed at the file and a version name
   encoding (model, uncertainty, aggregation).

CLI:
    python -m values_tpu_torch.evaluation.al_driver \\
        --splits <base_splits_dir> --config softmax_config_lidc \\
        [--device cuda|cpu] [--train-override key=value ...] [--dry-run]

trains on every ``secondCycle/**/splits_seed*.pkl`` under the base
splits dir. The versions are named ``secondCycle-<model>-<unc>-<agg>-
seed<N>``, which is not the layout ``metrics/al_improvement.py`` reads
(ROADMAP.md, Queue 3): as in the JAX package, the user moves the second
cycle's test_3d trees there.
"""
from __future__ import annotations

import argparse
import functools
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def discover_second_cycle_splits(base_splits_path) -> List[Path]:
    """Every secondCycle splits file under a base splits dir, sorted for
    a deterministic run order. Layout (second_cycle.py:save_splits):
    <base>/[<shift>/]secondCycle/<model>/<unc>/<agg>/splits_seed<seed>.pkl
    """
    base = Path(base_splits_path)
    return sorted(base.glob("**/secondCycle/**/splits_seed*.pkl"))


def version_name_for_splits(splits_file: Path) -> str:
    """The acquisition's provenance as the training version:
    secondCycle-<model>-<uncertainty>-<aggregation>-seed<N> for an
    uncertainty query, secondCycle-<type>-<type>-seed<N> for a random
    baseline (saved one level shallower)."""
    parts = splits_file.parts
    idx = parts.index("secondCycle")
    provenance = parts[idx + 1:-1]
    seed = splits_file.stem.replace("splits_", "")
    return "secondCycle-" + "-".join(provenance) + f"-{seed}"


def train_second_cycle(config_name: str, splits_file,
                       overrides: Optional[Sequence[str]] = None,
                       config_dir: str = "configs",
                       fit_fn=None, device=None) -> str:
    """One second-cycle training run; returns the checkpoint path.
    ``fit_fn(cfg)`` replaces ``fit(cfg, device=device)``."""
    from ..config import compose
    from ..training.loops import fit
    fit_fn = fit_fn or functools.partial(fit, device=device)
    splits_file = Path(splits_file)
    cfg = compose(config_dir, config_name, [
        f"datamodule.splits_path={splits_file}",
        f"version={version_name_for_splits(splits_file)}",
    ] + list(overrides or []))
    return fit_fn(cfg)


def run_second_cycle(base_splits_path, config_name: str,
                     overrides: Optional[Sequence[str]] = None,
                     config_dir: str = "configs",
                     dry_run: bool = False, fit_fn=None,
                     device=None) -> Dict[str, str]:
    """Train on every discovered secondCycle splits file. Returns
    {version_name: checkpoint_path} ("(dry-run)" paths when dry_run)."""
    results: Dict[str, str] = {}
    for splits_file in discover_second_cycle_splits(base_splits_path):
        version = version_name_for_splits(splits_file)
        if dry_run:
            results[version] = "(dry-run)"
            continue
        results[version] = train_second_cycle(
            config_name, splits_file, overrides=overrides,
            config_dir=config_dir, fit_fn=fit_fn, device=device)
    return results


def generate_and_run(eval_config, base_splits_path, config_name: str,
                     overrides: Optional[Sequence[str]] = None,
                     config_dir: str = "configs",
                     include_random_baselines: bool = True,
                     fit_fn=None, device=None) -> Dict[str, str]:
    """The whole loop: query-split generation from an evaluated
    experiment, then second-cycle training on everything produced."""
    from .experiment_dataloader import ExperimentDataloader
    from .split_file_generation.second_cycle import generate_split_file
    from .split_file_generation.second_cycle_random import (
        generate_split_file as generate_random_split_file)

    versions = (eval_config if isinstance(eval_config, (list, tuple))
                else [eval_config])
    for version in versions:
        exp_dl = (version if isinstance(version, ExperimentDataloader)
                  else ExperimentDataloader(version))
        generate_split_file(exp_dl, base_splits_path)
        if include_random_baselines:
            generate_random_split_file(
                exp_dl, base_splits_path,
                random_types=["random", "best", "worst"])
    return run_second_cycle(base_splits_path, config_name,
                            overrides=overrides, config_dir=config_dir,
                            fit_fn=fit_fn, device=device)


def main(argv=None) -> Dict[str, str]:
    parser = argparse.ArgumentParser(
        description="Second-cycle AL training driver")
    parser.add_argument("--splits", required=True,
                        help="base splits dir (contains firstCycle/ and "
                             "secondCycle/ trees)")
    parser.add_argument("--config", required=True,
                        help="training config name (e.g. "
                             "softmax_config_lidc)")
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, or cpu for "
                        "the kernels' plain versions)")
    parser.add_argument("--train-override", action="append", default=[],
                        help="extra config override, repeatable")
    parser.add_argument("--dry-run", action="store_true",
                        help="list the runs without training")
    args = parser.parse_args(argv)
    results = run_second_cycle(args.splits, args.config,
                               overrides=args.train_override,
                               config_dir=args.config_dir,
                               dry_run=args.dry_run, device=args.device)
    for version, ckpt in results.items():
        print(f"{version}: {ckpt}")
    if not results:
        print("no secondCycle splits found under", args.splits)
    return results


if __name__ == "__main__":
    main()
