"""The port's 2D sliding window (values_tpu_torch.inference.window2d)
against the JAX package's: the flush-to-edge starts, SlidingPredictor2D's
regular padded grid (the stride snapped to a divisor of the patch, the
reflect or edge pad), pixel-local exactness at the production geometry,
and a small real HRNet through both predictors -- which, unlike a
pixel-local model, tells the two grids apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hrnet import small_cfg
from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.inference import window2d as JW
from values_tpu.models.hrnet import HighResolutionNet as JaxHRNet
from values_tpu_torch.inference import window2d as PW
from values_tpu_torch.models.hrnet import get_seg_model
from values_tpu_torch.models.torch_import import (hrnet_params_to_torch,
                                                  strip_model_prefix)

GRIDS = [((100, 70), (64, 64), 0.5), ((1024, 1912), (256, 478), 0.5),
         ((300, 200), (256, 478), 0.5), ((48, 40), (32, 32), 0.5),
         ((10, 40), (32, 32), 0.5), ((50, 37), (16, 16), 0.3),
         ((61, 83), (24, 20), 0.75)]


@pytest.mark.parametrize("shape,patch,overlap", GRIDS)
def test_flush_to_edge_starts_match_jax(shape, patch, overlap):
    np.testing.assert_array_equal(
        PW.enumerate_window_starts_2d(shape, patch, overlap),
        JW.enumerate_window_starts_2d(shape, patch, overlap))


@pytest.mark.parametrize("shape,patch,overlap", GRIDS)
def test_regular_grid_matches_sliding_predictor(shape, patch, overlap,
                                                monkeypatch):
    """The padded size and the pad mode that the JAX SlidingPredictor2D
    takes (captured from its ``_build_run`` and ``np.pad`` calls), its
    snapped strides, and its row-major grid of starts."""
    nc = 3
    jsp = JW.SlidingPredictor2D(None, patch, nc, overlap=overlap)
    seen = {}

    def build_run(hp, wp, channels):
        seen["padded"] = (hp, wp)
        return lambda image, variables, rng: jnp.zeros((hp, wp, nc))

    real_pad = np.pad

    def pad(array, pad_width, mode="constant", **kw):
        seen["mode"] = mode
        return real_pad(array, pad_width, mode=mode, **kw)

    monkeypatch.setattr(jsp, "_build_run", build_run)
    monkeypatch.setattr(JW.np, "pad", pad)
    jsp({}, np.zeros(shape + (3,), np.float32), None)
    psp = PW.SlidingPredictor2D(None, patch, nc, overlap=overlap)
    sh, sw = jsp._strides()
    assert psp.strides() == (sh, sw)
    hp, wp, mode, starts = psp.grid(*shape)
    assert (hp, wp) == seen["padded"]
    assert mode == seen.get("mode", "reflect")
    if (hp, wp) == shape:
        assert "mode" not in seen
    kh, kw = (hp - patch[0]) // sh + 1, (wp - patch[1]) // sw + 1
    np.testing.assert_array_equal(
        starts, [(a * sh, b * sw) for a in range(kh) for b in range(kw)])


class _PixelLocal(torch.nn.Module):
    """24 logits per pixel from its own 3 channels: any count-averaged
    window placement reproduces the whole image's softmax."""

    def forward(self, x, generator=None):
        return torch.stack([x[:, i % 3] * (0.3 + 0.1 * i)
                            for i in range(24)], dim=1)


@pytest.mark.parametrize("shape", [(1024, 1912), (300, 200)])
def test_pixel_local_predictor_is_exact(shape):
    """SlidingPredictor2D at 256x478 windows: the production 1024x1912
    image (no pad, 7 x 7 windows, a ragged last batch) and 300x200 (reflect
    pad on both axes)."""
    img = torch.from_numpy(
        np.random.RandomState(0).rand(3, *shape).astype(np.float32))
    model = _PixelLocal()
    out = PW.SlidingPredictor2D(model, (256, 478), 24)(img)
    whole = torch.softmax(model(img[None]), dim=1)[0]
    assert out.shape == (24,) + shape
    torch.testing.assert_close(out, whole, atol=1e-5, rtol=0)


def test_pixel_local_flush_to_edge_is_exact():
    """predict_sliding_2d on the flush-to-edge grid at 1024x1912 and on an
    image narrower than the patch (reflect pad, cropped back)."""
    model = _PixelLocal()

    def forward(x):
        return torch.softmax(model(x), dim=1)

    img = torch.from_numpy(
        np.random.RandomState(1).rand(3, 1024, 1912).astype(np.float32))
    out = PW.predict_sliding_2d(forward, img, (256, 478), 24)
    torch.testing.assert_close(out, forward(img[None])[0], atol=1e-5,
                               rtol=0)
    narrow = img[:, :50, :9]
    out = PW.predict_sliding_2d(forward, narrow, (16, 16), 24)
    torch.testing.assert_close(out, forward(narrow[None])[0], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "edge"])
def test_pad_matches_numpy(mode):
    """Pads shorter and longer than the image, as np.pad takes them."""
    img = np.random.RandomState(3).rand(2, 5, 3)
    for hp, wp in ((5, 3), (9, 4), (23, 17)):
        want = np.pad(img, ((0, 0), (0, hp - 5), (0, wp - 3)), mode=mode)
        got = PW.pad_bottom_right(torch.from_numpy(img), hp, wp, mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def small_hrnet():
    cfg = small_cfg(num_classes=5)
    model = JaxHRNet(cfg=cfg)
    v = flax_init(model, 0, jnp.zeros((1, 32, 32, 3)))
    rs = np.random.RandomState(5)
    v["batch_stats"] = {
        k: {"mean": (rs.randn(*s["mean"].shape) * 0.1).astype(np.float32),
            "var": (rs.rand(*s["var"].shape) + 0.5).astype(np.float32)}
        for k, s in v["batch_stats"].items()}
    port = get_seg_model(cfg)
    port.load_state_dict(strip_model_prefix(hrnet_params_to_torch(v, cfg)))
    return model, v, port


@pytest.mark.parametrize("shape", [(48, 40), (10, 40)],
                         ids=["reflect", "edge"])
def test_small_hrnet_matches_sliding_predictor(small_hrnet, shape):
    """A real small HRNet (random BN statistics) under the JAX
    SlidingPredictor2D and the port's: the grid, the pad (reflect at
    48x40, edge at 10x40) and the count average agree within 1e-5, and
    the flush-to-edge grid gives a map farther off than 1e-3. Float32:
    the JAX predictor does not run under x64 (its window starts mix int32
    and int64 in ``dynamic_slice``, window2d.py:153; ROADMAP.md R10)."""
    model, v, port = small_hrnet
    img = np.random.RandomState(2).randn(*shape, 3).astype(np.float32)
    want = JW.SlidingPredictor2D(model, (32, 32), 5)(
        v, img, jax.random.PRNGKey(0))
    x = torch.from_numpy(img).permute(2, 0, 1)
    with torch.no_grad():
        got = PW.SlidingPredictor2D(port, (32, 32), 5)(x)
        flush = PW.predict_sliding_2d(
            lambda w: torch.softmax(port(w), dim=1), x, (32, 32), 5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want,
                               atol=1e-5)
    assert np.abs(flush.permute(1, 2, 0).numpy() - want).max() > 1e-3
