"""The port's sampled C1 paths against the benchmark's plain references
(``benchmark/reference/hrnet_ssn.py``, ``benchmark/reference/
aleatoric.py``), at tiny sizes on the CPU, on seeded random weights and
the same normals: the SSN HRNet's low-rank normal, its samples, its
swapped uncertainty maps and GED, in float64; and the aleatoric scorer's
scores, from the bits K3 draws. The references import nothing of the
port."""
import pytest
import torch

from benchmark import inputs
from benchmark.drivers import scorer_alea
from benchmark.reference import aleatoric as ref_alea
from benchmark.reference import hrnet_ssn, measures
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.inference.scoring import make_aleatoric_scorer
from values_tpu_torch.models.ensemble_unet3d import cast_weights
from values_tpu_torch.models.hrnet import HighResolutionNet
from values_tpu_torch.models.torch_import import group_member_state_dicts
from values_tpu_torch.ops import metrics as ops_metrics
from values_tpu_torch.ops import uncertainty as ops_uncertainty
from values_tpu_torch.ops.kernels import sampling

C, RANK, H, W, B, S = 5, 3, 32, 48, 2, 4


def _ssn_cfg():
    """A tiny SSN HRNet (every stage, widths cut)."""
    def stage(branches, block="BASIC"):
        return {"NUM_MODULES": 1, "NUM_BRANCHES": branches, "BLOCK": block,
                "NUM_BLOCKS": [1] * branches,
                "NUM_CHANNELS": [4 * 2 ** i for i in range(branches)],
                "DROPOUT": [False] * branches, "FUSE_METHOD": "SUM"}
    extra = {"FINAL_CONV_KERNEL": 1,
             "STAGE1": dict(stage(1, "BOTTLENECK"), NUM_CHANNELS=[8]),
             "STAGE2": stage(2), "STAGE3": stage(3), "STAGE4": stage(4)}
    return {"MODEL": {"NAME": "hrnet", "INPUT_CHANNELS": 3, "EXTRA": extra,
                      "SSN": True, "SSN_RANK": RANK, "SSN_EPS": 1e-5},
            "DATASET": {"NUM_CLASSES": C}}


@pytest.fixture(scope="module")
def ssn():
    """The port's and the reference's SSN HRNet on one float64 state with
    random BatchNorm statistics, and a batch of images and masks."""
    torch.manual_seed(0)
    port = HighResolutionNet(_ssn_cfg()).double().eval()
    for name, buf in port.named_buffers():
        if name.endswith("running_mean"):
            buf.normal_(0.0, 0.1)
        elif name.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
    ref = hrnet_ssn.HRNetSSN(_ssn_cfg()).double().eval()
    ref.load_state_dict(port.state_dict(), strict=True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((B, 3, H, W), generator=g, dtype=torch.float64)
    gt = torch.randint(0, C, (B, H, W), generator=g)
    gt[:, :3] = C                    # ignored rows, as the tester marks them
    return port, ref, x, gt


def test_ssn_distribution_and_samples_match(ssn):
    port, ref, x, _ = ssn
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    with torch.no_grad():
        dist = port(x)
        got = dist.rsample(gen, S)
        mean, cov_diag, factor = ref.distribution(x)
    for a, b in ((dist.mean, mean), (dist.cov_diag, cov_diag),
                 (dist.cov_factor, factor)):
        assert a.shape == b.shape
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
    assert not hrnet_ssn.degenerate(cov_diag, factor).any()
    ((eps_r, eps_d),) = hrnet_ssn.draw_normals(
        state, 1, S, B, RANK, mean.shape[1], torch.float64, "cpu")
    want = hrnet_ssn.samples(mean, cov_diag, factor, eps_r, eps_d)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    # the low-rank term is a real part of each sample
    flat = hrnet_ssn.samples(mean, cov_diag, torch.zeros_like(factor),
                             eps_r, eps_d)
    assert (want - flat).abs().max() > 1e-2


def test_ssn_maps_and_ged_match(ssn):
    """The tester's swapped maps and GED over the samples' softmax (the
    extra ignore channel added, as ``process_output`` adds it)."""
    port, ref, x, gt = ssn
    gen = torch.Generator().manual_seed(8)
    state = gen.get_state()
    with torch.no_grad():
        logits = port(x).rsample(gen, S).reshape(S, B, C, H, W)
        mean, cov_diag, factor = ref.distribution(x)
    probs = torch.softmax(logits, dim=2)
    ((eps_r, eps_d),) = hrnet_ssn.draw_normals(
        state, 1, S, B, RANK, mean.shape[1], torch.float64, "cpu")
    ref_probs = torch.softmax(hrnet_ssn.samples(
        mean, cov_diag, factor, eps_r, eps_d).reshape(S, B, C, H, W), dim=2)
    padded = torch.cat([probs, probs.new_zeros((S, B, 1, H, W))], dim=2)
    for k in range(B):
        maps = ops_uncertainty.uncertainty_measures(padded[:, k], ssn=True)
        want = hrnet_ssn.uncertainty_maps(ref_probs[:, k])
        assert set(maps) == set(want)
        for name in want:
            assert torch.allclose(maps[name], want[name], atol=1e-12)
        # the swap: an SSN's aleatoric map is MI, its epistemic map EE
        plain = ops_uncertainty.uncertainty_measures(padded[:, k])
        assert torch.equal(maps["aleatoric_uncertainty"],
                           plain["epistemic_uncertainty"])
        ged = ops_metrics.generalized_energy_distance(
            padded[:, k], gt[k][None], ignore_index=C, ged_only=True)["ged"]
        assert float(ged) == pytest.approx(
            float(measures.ged(ref_probs[:, k], gt[k][None], C)), abs=1e-12)


def test_degenerate_distribution_falls_back_to_the_diagonal():
    """A factor whose capacitance has no Cholesky (non-finite) is dropped:
    the sample is mean + sqrt(D) eps_d, as the port's fallback draws it."""
    from values_tpu_torch.models.ssn_unet3d import LowRankMVN
    g = torch.Generator().manual_seed(3)
    mean = torch.randn((2, 12), generator=g, dtype=torch.float64)
    cov_diag = torch.rand((2, 12), generator=g, dtype=torch.float64) + 0.5
    factor = torch.randn((2, 12, 3), generator=g, dtype=torch.float64)
    factor[1, 0, 0] = float("inf")
    assert hrnet_ssn.degenerate(cov_diag, factor).tolist() == [False, True]
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    got = LowRankMVN(mean, cov_diag, factor).rsample(gen, 2)
    ((eps_r, eps_d),) = hrnet_ssn.draw_normals(state, 1, 2, 2, 3, 12,
                                               torch.float64, "cpu")
    want = hrnet_ssn.samples(mean, cov_diag, factor, eps_r, eps_d)
    assert torch.allclose(got, want, atol=1e-12)
    assert torch.allclose(want[:, 1], mean[1] + cov_diag[1].sqrt()
                          * eps_d[:, 1], atol=1e-12)


def test_aleatoric_normals_are_the_bits_k3_draws():
    """The reference's z from its copy of the plain Philox: the program's
    bits, and within float32 rounding of the program's own z (Acklam in
    float32 there; its central branch cancels near its edges)."""
    n, m, c, s, seed = 64, 2, 3, 3, 2 ** 33 + 5
    bits = sampling.sample_bits_reference(n, m, c, seed, n_samples=s)
    for im, i, z in ref_alea.normals(seed, n, m, s, c, "cpu"):
        word = bits[:, im, i]
        u = ((word >> 8).double() * 2.0 ** -24 + 2.0 ** -26)
        assert torch.equal(z, ref_alea.inverse_normal_cdf(u))
        mine = sampling.inverse_normal_cdf(sampling.uniform_from_bits(word))
        assert torch.allclose(z, mine.double(), atol=3e-4)


def test_aleatoric_scores_match():
    """``make_aleatoric_scorer`` in float64 on the CPU against the
    reference on the same weights and draws. The scorer's rows are
    float32 and its z is Acklam's in float32 (up to 1.3e-4 off the
    float64 evaluation near the central branch's edges), hence rtol
    1e-4; a quarter of the samples' noise, or none, moves them by more
    than 1e-3."""
    model = {"num_classes": 2, "in_channels": 1, "initial_filter_size": 4}
    gen = inputs.generator(3, "cpu")
    states = inputs.unet3d_states(model, 2, gen, "cpu")
    scorer_alea.aleatoric_heads(states, model, gen, "cpu")
    vols, masks = inputs.volume_pool(gen, 2, 16, 4, (0.1, 0.5), "cpu")
    score, _ = make_aleatoric_scorer(2, 16, n_aleatoric_samples=4,
                                     agg_patch=4, dtype=torch.float64,
                                     device="cpu")
    got = score(cast_weights(group_member_state_dicts(states), torch.float64,
                             "cpu"), vols, masks, 12345).double()
    x = vols.permute(0, 4, 1, 2, 3).double()
    heads = [ref_alea.heads({k: v.double() for k, v in sd.items()}, x)
             for sd in states]
    mu, s = (torch.stack([h[i].movedim(1, -1).reshape(-1, 2)
                          for h in heads]) for i in (0, 1))
    stats = ref_alea.sampled_statistics(
        [(mu, s), (mu, s - 2 * torch.log(torch.tensor(4.0))),
         (mu, torch.full_like(s, -1e4))], 12345, 4)
    want, quieter, none = (ref_alea.volume_scores(
        st, masks, agg_patch=4, threshold=0.3, ignore_index=0)
        for st in stats)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-8)
    for other in (quieter, none):
        assert ((other - want).abs() / want.abs().clamp(min=1e-12)).max() \
            > 1e-3
