"""The 2D SSN's training in the port (the HRNet's SSN head, RMSprop,
``pretrain``) against the JAX package's ``Experiment``: one mean-only
pretraining step, then one step of the full low-rank head, in float64 as
tests/test_torch_training_2d.py explains, the JAX step's SSN normals
(``LowRankMVN.rsample``'s ``k1, k2 = split(key)`` of the step key)
replayed through ``values_tpu_torch.models.ssn_unet3d.draw_ssn_normals``.
The factor head has no gradient while pretraining: both packages give it
a zero one, and RMSprop's weight decay moves it (by lr * g / (sqrt(n) +
eps), about 10 lr on the first step) -- held leaf by leaf like the rest.
Limits as in tests/test_torch_training_2d.py."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_training_2d import (CLASSES, H, W, batches,
                                          check_steps, config, jax_steps,
                                          jax_variables, port_steps)
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.models import ssn_unet3d as PS

RANK = 3      # small_cfg's SSN_RANK
SAMPLES = 2   # config()'s n_aleatoric_samples


def _normals(rng, exp):
    k1, k2 = jax.random.split(rng)
    dim = CLASSES * H * W
    return (torch.from_numpy(np.array(jax.random.normal(
        k1, (SAMPLES, 2, RANK), jnp.float64))),
        torch.from_numpy(np.array(jax.random.normal(
            k2, (SAMPLES, 2, dim), jnp.float64))))


@pytest.fixture(scope="module")
def ssn_run():
    v0 = jax_variables(ssn=True)
    data = batches(2, seed=2)
    return v0, data, jax_steps(config("rmsprop", ssn=True), v0, data,
                               pretrain=(0,), normals=_normals, ssn=True)


def test_ssn_pretrain_then_full_step_match_jax(ssn_run, monkeypatch):
    v0, data, (losses, snaps, _, draws) = ssn_run
    queue = collections.deque(draws)

    def replayed(generator, n, batch, rank, dim, dtype, device):
        eps_r, eps_d = queue.popleft()
        assert eps_r.shape == (n, batch, rank)
        assert eps_d.shape == (n, batch, dim)
        return eps_r.to(dtype), eps_d.to(dtype)

    monkeypatch.setattr(PS, "draw_ssn_normals", replayed)
    got_losses, got, exp, _ = port_steps(config("rmsprop", ssn=True), v0,
                                         data, pretrain=(0,))
    assert exp.is_ssn and not queue
    check_steps(got, snaps, got_losses, losses)
    # the factor head: untouched by the pretraining loss, its kernel
    # moved by the decay (its zero-initialised biases stay 0)
    for module in ("cov_factor_conv_0", "cov_factor_conv_3"):
        before = v0["params"][module]["kernel"]
        after = got[0]["params"][module]["kernel"]
        assert np.abs(after - before).max() > 1e-3
        np.testing.assert_array_equal(got[0]["params"][module]["bias"],
                                      v0["params"][module]["bias"])
    np.testing.assert_array_equal(
        got[0]["batch_stats"]["cov_factor_conv_1"]["mean"],
        v0["batch_stats"]["cov_factor_conv_1"]["mean"])


def test_ssn_val_step_samples_the_running_head(ssn_run):
    """val_step: the SSN's log-likelihood and the mean Dice of its
    samples' argmax, on the running statistics, finite and in range (at
    the initial weights: RMSprop's first steps move every weight by
    about 10 lr, after which this small head's exp overflows float32)."""
    from values_tpu_torch.config import make_config
    from values_tpu_torch.training.experiment import Experiment
    v0, data, _ = ssn_run
    exp = Experiment(make_config(config("rmsprop", ssn=True)), "cpu")
    state = exp.state_from_variables(v0)
    out = exp.val_step(state.params, {
        "data": torch.tensor(data[0]["data"], dtype=torch.float32),
        "seg": torch.tensor(data[0]["seg"])},
        torch.Generator().manual_seed(0))
    assert np.isfinite(float(out["val_loss"]))
    assert 0 <= float(out["val_dice"]) <= 1
    assert state.params.training
