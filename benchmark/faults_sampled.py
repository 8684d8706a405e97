"""Faults planted underneath the sampled cells' timed paths (the SSN
HRNet's 2D test, the aleatoric scorer), for showing that their output
checks fail them, as :mod:`.faults` does for the other cells; with the
faults of :mod:`.faults` that these paths also run through. The
benchmark's own runs never plant one.
"""
from __future__ import annotations

from . import faults


def ssn_no_low_rank():
    """Every SSN sample drawn without its low-rank term W eps_r: the
    factor zeroed where the sampling terms are formed."""
    import torch
    from values_tpu_torch.models.ssn_unet3d import LowRankMVN

    def make(real):
        def terms(self):
            factor, sqrt_diag = real(self)
            return torch.zeros_like(factor), sqrt_diag
        return terms
    return faults._patched(LowRankMVN, "sampling_terms", make)


def alea_no_noise():
    """K3 handed a zero sigma: every logit sample is the member's mu."""
    import torch
    from values_tpu_torch.inference import scoring

    def make(real):
        def quiet(mu, sigma, seed, *, log_var=None, **kw):
            return real(mu, torch.zeros_like(mu), seed, **kw)
        return quiet
    return faults._patched(scoring, "sampled_softmax_stats", make)


FAULTS = {"tester2d_ssn": {"no_low_rank": ssn_no_low_rank,
                           "unswapped": faults.tester_altered,
                           "half_batch": faults.tester_half_batch},
          "scorer_alea": {"no_noise": alea_no_noise,
                          "half_batch": faults.scorer_half_batch,
                          "stale": faults.scorer_stale,
                          "altered": faults.scorer_altered}}
