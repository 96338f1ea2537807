"""PyTorch port, SRS layer: sonic_tpu_torch.srs and convert.srs vs
sonic_tpu.srs. G1 tables are compared limb for limb (both store affine
rows), G2 rows as host points. All comparisons are exact.
"""
import numpy as np
import torch

from sonic_tpu.fields.limb import FQ as JFQ
from sonic_tpu.srs import SRS as JSRS
from sonic_tpu_torch import convert
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.fields.limb import FQ
from sonic_tpu_torch.srs import SRS

torch.set_num_threads(1)


def _assert_table(jax_table, table):
    assert np.array_equal(np.asarray(jax_table.inf), table.inf.numpy())
    for a, b in ((jax_table.x, table.x), (jax_table.y, table.y)):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_srs_from_host_and_convert_match_sonic_tpu():
    """Row = exponent + d, the g^alpha hole at e = 0, the G2 rows pcV
    reads; convert.srs of the JAX tables gives the same record."""
    d, x, alpha = 6, 987654321, 123456789
    host = gp.SRS.new(d, x, alpha)
    want = JSRS.from_host(host)
    got = SRS.from_host(host)
    assert got.d == want.d == d
    _assert_table(want.g_x, got.g_x)
    _assert_table(want.g_ax, got.g_ax)
    assert bool(got.g_ax.inf[d]) and not bool(got.g_x.inf[d])
    assert FQ.to_int(got.g_x.x[d]) == host.g_pos_x[0][0]

    def table(t):
        return np.asarray(t.x), np.asarray(t.y), np.asarray(t.inf)

    conv = convert.srs(d, table(want.g_x), table(want.g_ax), table(want.h_x), table(want.h_ax))
    _assert_table(want.g_x, conv.g_x)
    _assert_table(want.g_ax, conv.g_ax)
    for e in range(-d, d + 1):
        assert got.h_x_at(e) == conv.h_x_at(e) == (host.h_pos_x[e] if e >= 0 else host.h_neg_x[-e - 1])
    for e in (0, 1):
        assert got.h_ax_at(e) == conv.h_ax_at(e) == host.h_pos_ax[e]


def test_srs_new_verifier_mode_matches_sonic_tpu():
    d, x, alpha = 40, 987654321, 123456789
    want = JSRS.new(d, x, alpha, h_mode="verifier", n_hints=[5])
    got = SRS.new(d, x, alpha, h_mode="verifier", n_hints=[5])
    for jt, t in ((want.g_x, got.g_x), (want.g_ax, got.g_ax)):
        assert np.array_equal(np.asarray(jt.inf), t.inf.numpy())
        assert list(JFQ.to_int(jt.x)) == list(FQ.to_int(t.x))
        assert list(JFQ.to_int(jt.y)) == list(FQ.to_int(t.y))
    assert bool(got.g_ax.inf[d]) and not bool(got.g_x.inf[d])
    for e in (5 - d, 0):
        assert got.h_x_at(e) == want.h_x_at(e)
    for e in (0, 1):
        assert got.h_ax_at(e) == want.h_ax_at(e)
