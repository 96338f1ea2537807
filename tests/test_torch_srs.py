"""PyTorch port, SRS layer: sonic_tpu_torch.srs, convert.srs and the SRS
checkpoints of sonic_tpu_torch.serial vs sonic_tpu.srs / sonic_tpu.serial
and the golden SRS. All four tables are compared limb for limb (both
packages store affine rows), host points as tuples; the full SRS also by
the pinned digest of tests/vectors/pinned_v1.json. All comparisons are
exact.
"""
import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from sonic_tpu import serial as jserial
from sonic_tpu.fields.limb import FQ as JFQ
from sonic_tpu.srs import SRS as JSRS
from sonic_tpu_torch import convert, serial
from sonic_tpu_torch import golden_protocol as gp
from sonic_tpu_torch.circuit import example_circuit_1
from sonic_tpu_torch.constraints import DeviceAssignment, DeviceCircuit
from sonic_tpu_torch.fields.limb import FQ
from sonic_tpu_torch.srs import SRS

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "pinned_v1.json")
with open(VEC_PATH) as f:
    VECTORS = json.load(f)

TABLES = ("g_x", "g_ax", "h_x", "h_ax")

torch.set_num_threads(1)


def _assert_table(jax_table, table):
    assert np.array_equal(np.asarray(jax_table.inf), table.inf.numpy())
    for a, b in ((jax_table.x, table.x), (jax_table.y, table.y)):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def _assert_tables(jax_srs, srs, names=TABLES):
    assert srs.d == jax_srs.d
    for name in names:
        _assert_table(getattr(jax_srs, name), getattr(srs, name))


def test_srs_from_host_and_convert_match_sonic_tpu():
    """Row = exponent + d, the g^alpha hole at e = 0, the G2 tables on the
    device, the G2 rows pcV reads; convert.srs of the JAX tables gives the
    same record, and to_host gives back the host SRS."""
    d, x, alpha = 6, 987654321, 123456789
    host = gp.SRS.new(d, x, alpha)
    want = JSRS.from_host(host)
    got = SRS.from_host(host, device="cpu")
    assert got.d == want.d == d
    _assert_tables(want, got)
    assert got.h_x.x.shape == (2 * d + 1, 2, FQ.nlimbs)
    assert bool(got.g_ax.inf[d]) and not bool(got.g_x.inf[d]) and not bool(got.h_ax.inf[d])
    assert FQ.to_int(got.g_x.x[d]) == host.g_pos_x[0][0]
    assert got.to_host() == host

    def table(t):
        return np.asarray(t.x), np.asarray(t.y), np.asarray(t.inf)

    conv = convert.srs(d, table(want.g_x), table(want.g_ax), table(want.h_x), table(want.h_ax),
                       device="cpu")
    _assert_tables(want, conv)
    for e in range(-d, d + 1):
        assert got.h_x_at(e) == conv.h_x_at(e) == (host.h_pos_x[e] if e >= 0 else host.h_neg_x[-e - 1])
    for e in (0, 1):
        assert got.h_ax_at(e) == conv.h_ax_at(e) == host.h_pos_ax[e]


def test_srs_new_verifier_mode_matches_sonic_tpu():
    d, x, alpha = 40, 987654321, 123456789
    want = JSRS.new(d, x, alpha, h_mode="verifier", n_hints=[5])
    got = SRS.new(d, x, alpha, h_mode="verifier", n_hints=[5], device="cpu")
    for jt, t in ((want.g_x, got.g_x), (want.g_ax, got.g_ax)):
        assert np.array_equal(np.asarray(jt.inf), t.inf.numpy())
        assert list(JFQ.to_int(jt.x)) == list(FQ.to_int(t.x))
        assert list(JFQ.to_int(jt.y)) == list(FQ.to_int(t.y))
    assert bool(got.g_ax.inf[d]) and not bool(got.g_x.inf[d])
    for e in (5 - d, 0):
        assert got.h_x_at(e) == want.h_x_at(e)
    for e in (0, 1):
        assert got.h_ax_at(e) == want.h_ax_at(e)


def _digest(srs: gp.SRS) -> str:
    """tests/test_vectors.py's SRS digest."""
    h = hashlib.sha256()
    for tab in (srs.g_neg_x, srs.g_pos_x, srs.g_neg_ax, srs.g_pos_ax):
        for p in tab:
            h.update(serial.g1_to_bytes(p))
    for tab in (srs.h_neg_x, srs.h_pos_x, srs.h_neg_ax, srs.h_pos_ax):
        for p in tab:
            h.update(serial.g2_to_bytes(p))
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_srs_new_full_reproduces_the_pinned_digest(name):
    vec = VECTORS[name]
    srs = SRS.new(vec["d"], vec["x"], vec["alpha"], device="cpu")
    assert _digest(srs.to_host()) == vec["srs_sha256"]


def test_srs_new_full_matches_sonic_tpu_and_golden():
    """d = 8 with a random trapdoor: all four tables equal sonic_tpu's
    SRS.new(h_mode="full") limb for limb and the golden SRS as points; the
    h rows pcV reads come from the device tables."""
    rng = random.Random(12)
    d, x, alpha = 8, rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    got = SRS.new(d, x, alpha, h_mode="full", device="cpu")
    _assert_tables(JSRS.new(d, x, alpha, h_mode="full"), got)
    host = gp.SRS.new(d, x, alpha)
    assert got.to_host() == host
    assert got.h_x_at(-3) == host.h_neg_x[2] and got.h_ax_at(1) == host.h_pos_ax[1]
    with pytest.raises(ValueError, match="unknown h_mode"):
        SRS.new(d, x, alpha, h_mode="half", device="cpu")


def _verifier_mode(full, rows):
    """A verifier-mode SRS of either package from a full one: G1 tables,
    no G2 tables, the given h rows in its row cache."""
    if isinstance(full, JSRS):
        srs = JSRS(full.d, full.g_x, full.g_ax, None, None)
        srs._h_cache().update(rows)
        return srs
    srs = SRS(full.d, full.g_x, full.g_ax)
    srs.h_rows.update(rows)
    return srs


@pytest.mark.parametrize("mode", ["full", "verifier"])
def test_checkpoints_load_in_either_package(tmp_path, mode):
    """A checkpoint written by sonic_tpu.serial.save_srs loads in the port,
    and one written by the port loads in sonic_tpu, with equal tables (and
    equal h rows in verifier mode)."""
    d = 5
    host = gp.SRS.new(d, 987654321, 123456789)
    jsrs, srs = JSRS.from_host(host), SRS.from_host(host, device="cpu")
    names = TABLES if mode == "full" else TABLES[:2]
    if mode == "verifier":
        rows = {("x", 2 - d): host.h_neg_x[d - 3], ("x", 0): host.h_pos_x[0],
                ("ax", 0): host.h_pos_ax[0], ("ax", 1): host.h_pos_ax[1]}
        jsrs, srs = _verifier_mode(jsrs, rows), _verifier_mode(srs, rows)
    jserial.save_srs(str(tmp_path / "jax.npz"), jsrs)
    serial.save_srs(str(tmp_path / "port.npz"), srs)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    from_jax = serial.load_srs(str(tmp_path / "jax.npz"), device="cpu")
    from_port = jserial.load_srs(str(tmp_path / "port.npz"))
    _assert_tables(jsrs, from_jax, names)
    _assert_tables(from_port, srs, names)
    if mode == "full":
        # the two packages' host SRS classes differ: compare their fields
        assert vars(from_jax.to_host()) == vars(from_port.to_host()) == vars(host)
    else:
        assert from_jax.h_x is None and from_jax.h_rows == rows == from_port._h_cache()


def test_constructors_default_to_the_card(monkeypatch):
    """With no `device`, the public constructors put their tensors on the
    card; without one they raise rather than hand back CPU tensors."""
    host = gp.SRS.new(2, 987654321, 123456789)
    circuit, assignment = example_circuit_1(x=1, z=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    limbs = np.zeros((1, 16), np.uint32)
    for make in (
        lambda: SRS.from_host(host),
        lambda: SRS.new(2, 987654321, 123456789),
        lambda: DeviceCircuit.from_host(circuit),
        lambda: DeviceAssignment.from_host(assignment),
        lambda: convert.srs(2, None, None, None, None),
        lambda: serial.load_srs("unused.npz"),
        lambda: convert.circuit(limbs, limbs, limbs, limbs),
        lambda: convert.assignment(limbs, limbs, limbs),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert SRS.from_host(host, device="cpu").g_x.x.device.type == "cpu"
    assert DeviceCircuit.from_host(circuit, device="cpu").wL.device.type == "cpu"
