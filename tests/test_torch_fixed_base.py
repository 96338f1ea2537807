"""PyTorch port, setup in chunks: `msm.fixed_base.fixed_base_mul` cut
into row chunks within `budget.STEP_BYTES` (`chunk_rows`, at
`budget.BASE_ROW_BYTES` a row of each group) against the uncut call and
sonic_tpu's `fixed_base_mul` with its own `max_chunk` split, and a full
SRS.new built a chunk of rows at a time: the same tables as the uncut one
and the golden SRS, and its checkpoint (`serial.save_srs`) read back by
`sonic_tpu.serial.load_srs` field by field. All comparisons are exact.
"""
import numpy as np
import pytest
import torch

from sonic_tpu import golden as jgolden
from sonic_tpu import serial as jserial
from sonic_tpu.curve.group import g1 as jg1
from sonic_tpu.curve.group import g2 as jg2
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.msm.fixed_base import fixed_base_mul as jax_fixed_base_mul
from sonic_tpu_torch import budget, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.curve.group import g1, g2
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.msm import fixed_base
from sonic_tpu_torch.srs import SRS

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _counting_tables(monkeypatch):
    """Count fixed_base_mul's chunks: each one looks its window table up."""
    calls = []
    real = fixed_base.table
    monkeypatch.setattr(fixed_base, "table", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_chunked_fixed_base_mul_matches_uncut_and_jax(name, monkeypatch):
    """Ten scalars (0, 1, r-1 and random ones) in chunks of 3 rows: four
    chunks whose projective rows equal the uncut call's limb for limb
    (every row is its own chain of additions), and whose affine rows equal
    sonic_tpu's fixed_base_mul cut at max_chunk = 4 rows and golden."""
    grp, jgrp = (g1, jg1) if name == "G1" else (g2, jg2)
    host_mul, gen = (jgolden.g1_mul, jgolden.G1_GEN) if name == "G1" else (jgolden.g2_mul, jgolden.G2_GEN)
    rng = np.random.default_rng(61)
    ks = [0, 1, R_MOD - 1] + [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(7)]
    js = JFR.from_int(ks, mont=False)
    whole = fixed_base.fixed_base_mul(grp, to_torch(js))
    monkeypatch.setattr(budget, "STEP_BYTES", 3 * budget.BASE_ROW_BYTES[name])
    assert fixed_base.chunk_rows(grp) == 3
    calls = _counting_tables(monkeypatch)
    got = fixed_base.fixed_base_mul(grp, to_torch(js))
    assert len(calls) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    aff = grp.to_affine(got)
    want = jgrp.to_affine(jax_fixed_base_mul(jgrp, js, max_chunk=4))
    assert np.array_equal(np.asarray(want.x).astype(np.int64), aff.x.numpy())
    assert np.array_equal(np.asarray(want.y).astype(np.int64), aff.y.numpy())
    assert np.array_equal(np.asarray(want.inf), aff.inf.numpy())
    assert grp.to_host(aff) == [host_mul(gen, k) for k in ks]


def test_chunked_full_srs_checkpoint_reads_in_sonic_tpu(tmp_path, monkeypatch):
    """SRS.new(h_mode="full") at d = 6 with chunks of 5 G1 and 3 G2 rows
    (fixed_base_mul and to_affine a chunk at a time: 13 rows a table, 26
    rows a group): the tables equal the uncut SRS's, the golden SRS is
    its host form, and the checkpoint the port writes loads in
    sonic_tpu.serial with every table equal limb for limb."""
    d, x, alpha = 6, 987654321, 123456789
    whole = SRS.new(d, x, alpha, h_mode="full", device="cpu")
    monkeypatch.setattr(budget, "STEP_BYTES", 15 * budget.BASE_ROW_BYTES["G2"])
    monkeypatch.setattr(budget, "BASE_ROW_BYTES", {"G1": 3 * budget.BASE_ROW_BYTES["G2"],
                                                   "G2": budget.BASE_ROW_BYTES["G2"] * 5})
    assert (fixed_base.chunk_rows(g1), fixed_base.chunk_rows(g2)) == (5, 3)
    calls = _counting_tables(monkeypatch)
    srs = SRS.new(d, x, alpha, h_mode="full", device="cpu")
    assert len(calls) == 6 + 9  # ceil(26 / 5) G1 chunks, ceil(26 / 3) G2 chunks
    for name in ("g_x", "g_ax", "h_x", "h_ax"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(srs, name), getattr(whole, name))), name
    assert vars(srs.to_host()) == vars(gp.SRS.new(d, x, alpha))
    path = str(tmp_path / "port.npz")
    serial.save_srs(path, srs)
    loaded = jserial.load_srs(path)
    assert loaded.d == d
    for name in ("g_x", "g_ax", "h_x", "h_ax"):
        jt, t = getattr(loaded, name), getattr(srs, name)
        assert np.array_equal(np.asarray(jt.x).astype(np.int64), t.x.numpy()), name
        assert np.array_equal(np.asarray(jt.y).astype(np.int64), t.y.numpy()), name
        assert np.array_equal(np.asarray(jt.inf), t.inf.numpy()), name
