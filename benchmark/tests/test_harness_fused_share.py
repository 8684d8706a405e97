"""``fused_sample_share.ssn``: the share of the SSN's samples that the
fused sampling kernels drew, read from the program's counters; nothing
where the program counted no fused sample (a program without the
kernels) or recorded no tested batch."""
import pytest

from benchmark import harness


def _read(monkeypatch, summary, totals):
    from values_tpu_torch.core import tracing
    monkeypatch.setattr(tracing, "summary", lambda: summary)
    monkeypatch.setattr(tracing, "totals", lambda: totals)
    return harness.reader("metrics", "fused_sample_share.ssn").read(None)


@pytest.mark.parametrize("totals,want", [
    ({"ssn_samples": 120, "ssn_fused_samples": 120}, 1.0),
    ({"ssn_samples": 120, "ssn_fused_samples": 60}, 0.5),
    ({"ssn_samples": 120}, None),
    ({}, None),
])
def test_share_of_fused_samples(monkeypatch, totals, want):
    batches = {"test2d.batch": {"calls": 2, "host_ms": 200.0}}
    assert _read(monkeypatch, batches, totals) == want
    assert _read(monkeypatch, {}, totals) is None
