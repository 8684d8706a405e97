"""The port's HRNet-W48 on the card against its CPU forward (``cuda``
marker: skipped without a card). No flax here, so the file runs on the
card's machine: ``python -m pytest tests/test_torch_hrnet_cuda.py -m
cuda``. The configs are configs/gta_softmax_config.yaml and
gta_ssn_config.yaml at their published widths, on a 64x96 input."""
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.config import compose
from values_tpu_torch.models.hrnet import get_seg_model


def _model(config):
    cfg = compose("configs", config, ["data_input_dir=/none",
                                      "save_dir=/none", "version=0"])
    torch.manual_seed(0)
    return get_seg_model(cfg.to_container()["model"]["cfg"])


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["gta_softmax_config", "gta_ssn_config"])
def test_forward_on_cuda_matches_cpu(config):
    """Channels-last on the card with cuDNN's TF32 off, against the CPU
    forward in float32: the logits (the SSN's mean and factor) within
    1e-4 of their max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _model(config)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 64, 96).astype(np.float32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(x)
            card = model.cuda().to(memory_format=torch.channels_last)
            got = card(x.cuda().contiguous(
                memory_format=torch.channels_last))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    pairs = ([(got.mean, want.mean), (got.cov_factor, want.cov_factor)]
             if config == "gta_ssn_config" else [(got, want)])
    for g, w in pairs:
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()
