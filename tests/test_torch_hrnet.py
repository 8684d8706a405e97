"""The port's HRNet (values_tpu_torch.models.hrnet) and its weight bridge
(torch_import.hrnet_params_to_torch) against the JAX package's flax HRNet
on the same weights: the small config of tests/test_hrnet.py, random BN
running statistics (so eval-mode BN is exercised) and a 37x53 input, which
32 does not divide, so every bilinear resize has a non-integer scale."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hrnet import small_cfg
from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.models.hrnet import HighResolutionNet as JaxHRNet
from values_tpu.models.torch_import import hrnet_params_from_torch
from values_tpu.training.checkpoint import save_checkpoint as jax_save
from values_tpu_torch.models import hrnet as H
from values_tpu_torch.models.torch_import import (hrnet_params_to_torch,
                                                  strip_model_prefix)
from values_tpu_torch.training.checkpoint import load_any_checkpoint

C, B, HH, WW = 5, 2, 37, 53
HEADS = ["plain", "dropout_final", "ssn"]


def _cfg(head):
    return small_cfg(num_classes=C, ssn=head == "ssn",
                     dropout_final=head == "dropout_final")


def _variables(cfg, seed=0):
    """flax-initialized variables (float64) with random running stats."""
    v = flax_init(JaxHRNet(cfg=cfg), seed, jnp.zeros((1, 32, 32, 3)),
                  dtype=np.float64)
    rs = np.random.RandomState(seed + 1)
    v["batch_stats"] = {
        k: {"mean": rs.randn(*s["mean"].shape) * 0.1,
            "var": rs.rand(*s["var"].shape) + 0.5}
        for k, s in v["batch_stats"].items()}
    return v


def _port_model(cfg, variables, dtype=torch.float64):
    model = H.get_seg_model(cfg).to(dtype)
    model.load_state_dict(strip_model_prefix(
        hrnet_params_to_torch(variables, cfg)))
    return model


def _input(seed=3):
    return np.random.RandomState(seed).randn(B, HH, WW, 3)


class _RecordedDropout:
    """flax ``nn.Dropout.__call__`` with its keep mask drawn as flax draws
    it (``bernoulli(make_rng('dropout'), keep_prob)``) and sown into
    ``intermediates``, so a jitted apply returns the masks it used."""

    def __init__(self):
        import flax.linen as nn
        self.nn, self.orig = nn, nn.Dropout.__call__

    def __enter__(self):
        def call(module, inputs, deterministic=None, rng=None):
            if self.nn.merge_param("deterministic", module.deterministic,
                                   deterministic):
                return inputs
            keep = 1.0 - module.rate
            mask = jax.random.bernoulli(module.make_rng("dropout"), keep,
                                        inputs.shape)
            module.sow("intermediates", "keep", mask)
            return jax.lax.select(mask, inputs / keep,
                                  jnp.zeros_like(inputs))
        self.nn.Dropout.__call__ = call
        return self

    def __exit__(self, *exc):
        self.nn.Dropout.__call__ = self.orig


@pytest.fixture(scope="module")
def jax_runs():
    """For each head: the variables, and the JAX float64 output on the
    37x53 input (the DROPOUT_FINAL run with its four keep masks)."""
    x = _input()
    runs = {}
    for head in HEADS:
        cfg = _cfg(head)
        v = _variables(cfg)
        model = JaxHRNet(cfg=cfg, dtype=jnp.float64,
                         param_dtype=jnp.float64)
        with jax.enable_x64(True):
            if head == "dropout_final":
                with _RecordedDropout():
                    out, inter = jax.jit(lambda v, x: model.apply(
                        v, x, rngs={"dropout": jax.random.PRNGKey(9)},
                        mutable=["intermediates"]))(v, jnp.asarray(x))
                masks = [np.asarray(m) for m in jax.tree_util.tree_leaves(
                    inter["intermediates"])]
                runs[head] = (v, np.asarray(out), masks)
                continue
            if head == "ssn":
                def apply(v, x):
                    dist = model.apply(v, x)
                    return dist.mean, dist.cov_diag, dist.cov_factor
                out = tuple(np.asarray(a) for a in
                            jax.jit(apply)(v, jnp.asarray(x)))
            else:
                out = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
        runs[head] = (v, out, None)
    return runs


@pytest.mark.parametrize("head", HEADS)
def test_forward_matches_flax_f64(jax_runs, head, monkeypatch):
    """Float64 at atol 1e-8 (PARITY.md's HRNet limit): the logits of the
    plain and the DROPOUT_FINAL model (the JAX masks replayed), the SSN's
    mean, cov_diag and cov_factor (factor channel r*C + c)."""
    variables, want, masks = jax_runs[head]
    cfg = _cfg(head)
    model = _port_model(cfg, variables)
    x = torch.from_numpy(_input()).permute(0, 3, 1, 2)
    if head == "dropout_final":
        # the four branch masks, NHWC -> NCHW, in branch order
        assert len(masks) == 4
        replay = iter(torch.from_numpy(np.array(m)).permute(0, 3, 1, 2)
                      for m in masks)

        def replayed(t, generator):
            keep = next(replay)
            assert keep.shape == t.shape
            return torch.where(keep, t / 0.5, torch.zeros_like(t))
        monkeypatch.setattr(H, "dropout_final", replayed)
    with torch.no_grad():
        got = model(x, generator=torch.Generator())
    if head == "ssn":
        for name, g, w in zip(("mean", "cov_diag", "cov_factor"),
                              (got.mean, got.cov_diag, got.cov_factor),
                              want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-8,
                                       err_msg=name)
        return
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-8)


def test_bf16_matches_flax_bf16(jax_runs):
    """bfloat16 against the JAX package's bfloat16 model (f32 weights cast,
    f32 softmax): the two round at different places (flax casts the BN
    statistics per op, torch holds them in bf16), so the softmaxes are
    held to a bf16-sized bound: mean |dp| < 5e-3 (the JAX package's own
    bf16-vs-f32 limit, tests/test_2d_path.py) and max |dp| < 0.1."""
    variables, _, _ = jax_runs["plain"]
    v32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), variables)
    cfg = _cfg("plain")
    x = _input().astype(np.float32)
    jm = JaxHRNet(cfg=cfg, dtype=jnp.bfloat16)
    want = jax.nn.softmax(jax.jit(jm.apply)(v32, jnp.asarray(x)).astype(
        jnp.float32), axis=-1)
    model = _port_model(cfg, v32, torch.bfloat16)
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(
            torch.bfloat16))
    got = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1).numpy()
    diff = np.abs(got - np.asarray(want))
    assert diff.mean() < 5e-3 and diff.max() < 0.1, (diff.mean(),
                                                     diff.max())


def test_dropout_final_rate_and_scaling():
    """The port draws its own masks (R2): about half the branch values are
    kept, each kept value doubled, the rest 0; two passes differ; the same
    seed repeats a pass."""
    t = torch.rand(4, 8, 16, 16) + 0.5
    gen = torch.Generator().manual_seed(0)
    out = H.dropout_final(t, gen)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    torch.testing.assert_close(out[kept], 2 * t[kept])
    assert not torch.equal(out, H.dropout_final(t, gen))
    torch.testing.assert_close(
        out, H.dropout_final(t, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="generator"):
        H.dropout_final(t, None)


def test_state_dict_keys_are_the_reference_keys(jax_runs):
    """The port's keys are the reference torch module's, and the bridge
    inverts the JAX package's ``hrnet_params_from_torch`` exactly."""
    variables, _, _ = jax_runs["ssn"]
    cfg = _cfg("ssn")
    keys = set(H.HighResolutionNet(cfg).state_dict())
    for key in ("conv1.weight", "bn2.running_var",
                "layer1.0.downsample.0.weight", "transition1.0.0.weight",
                "transition1.1.0.0.weight", "stage2.0.branches.1.1.conv2."
                "weight", "stage3.1.fuse_layers.2.0.1.0.weight",
                "stage4.0.fuse_layers.0.3.1.running_mean",
                "last_layer.3.bias", "cov_factor_conv.0.weight"):
        assert key in keys, key
    state = hrnet_params_to_torch(variables, cfg)
    back = hrnet_params_from_torch(state, dtype=np.float64)
    for coll in ("params", "batch_stats"):
        assert sorted(back[coll]) == sorted(variables[coll])
        for name, leaves in variables[coll].items():
            for leaf, arr in leaves.items():
                np.testing.assert_array_equal(back[coll][name][leaf], arr)
    extra = dict(variables, params=dict(variables["params"],
                                        stray={"kernel": np.zeros(1)}))
    with pytest.raises(KeyError, match="stray"):
        hrnet_params_to_torch(extra, cfg)


def test_checkpoints_load_as_hrnet(jax_runs, tmp_path):
    """A JAX-written native HRNet checkpoint and a reference ``.ckpt`` of
    the same weights read back as the same state_dict."""
    variables, _, _ = jax_runs["plain"]
    cfg = _cfg("plain")
    hp = {"seed": 1, "model": {
        "_target_": "values_tpu.models.hrnet.get_seg_model", "cfg": cfg}}
    jax_save(str(tmp_path / "native.ckpt"), variables, hp)
    state = hrnet_params_to_torch(variables, cfg)
    torch.save({"state_dict": state, "hyper_parameters": hp},
               tmp_path / "ref.ckpt")
    for name in ("native.ckpt", "ref.ckpt"):
        got_hp, got = load_any_checkpoint(str(tmp_path / name))
        assert got_hp == hp
        assert sorted(got) == sorted(state)
        for k in state:
            torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
    with open(tmp_path / "native.ckpt", "rb") as f:
        assert "batch_stats" in pickle.load(f)["state_dict"]
