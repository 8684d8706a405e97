"""Least time of the SSN's sampling stage per tested batch (its bytes:
the mean, the diagonal and the factor read once, the samples' softmax
written once, float32, at the chip's peak bandwidth; counted from the
shapes) over the stream ms of its spans ``test2d.ssn_sample`` per batch,
in percent. The stream ms counts any idle of the device inside the span
besides its kernels' time, so the share is a floor of the kernels'."""
from benchmark import spans


def read(run):
    ms = spans.per_root("test2d.batch", "test2d.ssn_sample")
    if not ms:
        return None
    return 100.0 * run.work["ssn_sample_least_s_per_batch"] * 1e3 / ms
