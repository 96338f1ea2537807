"""PyTorch port, the MSM tail on the CPU (msm/tail.py's plain twins).

The card's window size, c = 6 (W = 44 signed windows, B = 33 buckets),
through `pippenger.msm` and `combine_windows`, against the golden host
MSM; the CPU picks c = 4, 7, 9 or 10 itself, so only these cases run the
card's shapes here. And the CPU path never reaches kernel 3: its
wrappers refuse CPU tensors and `tail.launches` stays put. Kernel 3
itself runs in tests/test_torch_cuda.py. All comparisons are exact, in
affine form.
"""
import random

import pytest
import torch

from sonic_tpu_torch import golden
from sonic_tpu_torch.curve.group import g1
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FQ, FR
from sonic_tpu_torch.msm import pippenger, tail
from sonic_tpu_torch.utils import trace

torch.set_num_threads(1)

CARD_C = pippenger.CUDA_C


def _points(rng, n, inf_at=()):
    pts = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(n)]
    for i in inf_at:
        pts[i] = None
    return pts, g1.from_host(pts)


def _scalars(rng, M, n):
    s = [[rng.randrange(R_MOD) for _ in range(n)] for _ in range(M)]
    s[0][1] = 0
    s[-1][-1] = R_MOD - 1
    return s


@pytest.mark.parametrize("how", ["msm", "msm_batched", "combine_windows"])
def test_plain_tail_at_the_cards_window_size(how):
    """c = 6 as on the card: one MSM, a batch of M = 3, and the two
    finished together with a c = 4 part by one combine_windows; every
    result equal to golden.g1_msm, and kernel 3 never launched."""
    rng = random.Random(613)
    n, M = 7, 3
    host, points = _points(rng, n, inf_at=(2,))
    scalars = _scalars(rng, M, n)
    sc = FR.from_int(scalars, mont=False)
    want = [golden.g1_msm(host, s) for s in scalars]
    before = tail.launches
    if how == "msm":
        got = [pippenger.msm(points, sc[0], c=CARD_C).map(lambda a: a[None])]
        want = want[:1]
    elif how == "msm_batched":
        got = [pippenger.msm_batched(points, sc, c=CARD_C)]
    else:
        parts = [pippenger.msm_windows(points, sc[0], c=CARD_C),
                 pippenger.msm_windows(points, sc, c=CARD_C),
                 pippenger.msm_windows(points, sc, c=4)]
        assert [p.totals.x.shape[-2] for p in parts] == [44, 44, 65]
        single, batch, batch4 = pippenger.combine_windows(parts)
        assert single.x.shape == (FQ.nlimbs,) and batch.x.shape == (M, FQ.nlimbs)
        got = [single.map(lambda a: a[None]), batch, batch4]
        want = want[:1] + want + want
    assert [p for j in got for p in g1.to_host(g1.to_affine(j))] == want
    assert tail.launches == before


def test_cpu_tail_never_reaches_kernel_3():
    """On CPU tensors pippenger takes the plain twins (bit-equal to them
    here) and the wrappers raise before any build or launch."""
    rng = random.Random(614)
    _, points = _points(rng, 4)
    j = g1.from_affine(points)
    totals = j.map(lambda a: a.reshape(2, 2, FQ.nlimbs))
    buckets = j.map(lambda a: a.reshape(1, 1, 4, FQ.nlimbs))
    before = tail.launches
    for got, want in ((pippenger._window_combine(totals, CARD_C), tail.window_combine_plain(totals, CARD_C)),
                      (pippenger._bucket_weighted_sum(buckets), tail.bucket_weighted_sum_plain(buckets))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        tail.window_combine(totals, CARD_C)
    with pytest.raises(ValueError):
        tail.bucket_weighted_sum(buckets)
    for c in (0, 17):
        with pytest.raises(ValueError):
            tail.window_combine(totals, c)
    assert tail.launches == before
    assert trace.COUNTERS["msm_tail.launches"] == ("sonic_tpu_torch.msm.tail", "launches")
    with trace.recording() as records:
        pippenger.msm(points, FR.from_int([3, 5, 7, 11], mont=False))
    assert records and all(r.counters["msm_tail.launches"] == 0 for r in records)
