"""PyTorch port, the reference's last public names, each against its JAX
counterpart: `__version__`, the field partials `limb.fr_add` ... `fq_inv`,
`group.Point`, the `G1` / `G2` classes and `GroupOps.affine_infinity`,
`pippenger.DEFAULT_C`, `ntt.ntt_batched`, and `msm` / `msm_batched`
called the reference's way, with a leading group. (`msm_sharded` with a
leading group, G2 included, runs in tests/test_torch_parallel.py's
worlds.) All comparisons are exact.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sonic_tpu
import sonic_tpu_torch
from sonic_tpu import golden
from sonic_tpu.curve import group as jgroup
from sonic_tpu.curve.group import Affine as JAffine
from sonic_tpu.fields import limb as jlimb
from sonic_tpu.fields.limb import FQ as JFQ
from sonic_tpu.fields.limb import FR as JFR
from sonic_tpu.msm import fixed_base as jfixed_base
from sonic_tpu.msm import pippenger as jpp
from sonic_tpu.poly import ntt as jntt
from sonic_tpu_torch.curve import group
from sonic_tpu_torch.curve.group import g1, g2
from sonic_tpu_torch.fields import limb
from sonic_tpu_torch.fields.constants import R_MOD
from sonic_tpu_torch.fields.limb import FR
from sonic_tpu_torch.msm import fixed_base, pippenger
from sonic_tpu_torch.poly import ntt

torch.set_num_threads(1)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_version_matches_jax():
    assert sonic_tpu_torch.__version__ == sonic_tpu.__version__ == "0.3.0"


@pytest.mark.parametrize("op", ["add", "sub", "mul", "inv"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_field_partials_match_jax(field, op):
    """fr_add ... fq_inv on random values, 0 and 1 (inv(0) = 0)."""
    jspec = JFR if field == "fr" else JFQ
    rng = random.Random(f"{field}-{op}")
    a = [rng.randrange(jspec.modulus) for _ in range(5)] + [0, 1]
    b = [rng.randrange(jspec.modulus) for _ in range(6)] + [1]
    ja, jb = jspec.from_int(a), jspec.from_int(b)
    jfn, fn = getattr(jlimb, f"{field}_{op}"), getattr(limb, f"{field}_{op}")
    want = jfn(ja) if op == "inv" else jfn(ja, jb)
    got = fn(to_torch(ja)) if op == "inv" else fn(to_torch(ja), to_torch(jb))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_group_names_match_jax():
    assert group.Point is group.Jacobian and jgroup.Point is jgroup.Jacobian
    for cls, jcls, inst, jinst in ((group.G1, jgroup.G1, g1, jgroup.g1), (group.G2, jgroup.G2, g2, jgroup.g2)):
        assert isinstance(inst, cls) and isinstance(jinst, jcls)
        assert cls().name == jcls().name == inst.name
        gen, jgen = cls().generator(), jcls().generator()
        assert np.array_equal(np.asarray(jgen.x).astype(np.int64), gen.x.numpy())
        assert np.array_equal(np.asarray(jgen.y).astype(np.int64), gen.y.numpy())
        want, got = jinst.affine_infinity((2, 3)), inst.affine_infinity((2, 3))
        for j, t in zip(want, got):
            assert tuple(t.shape) == j.shape
            assert np.array_equal(np.asarray(j).astype(t.numpy().dtype), t.numpy())
        assert inst.to_host(inst.affine_infinity((6,))) == [None] * 6


def test_default_c_matches_jax():
    assert pippenger.DEFAULT_C == jpp.DEFAULT_C == 8
    assert fixed_base.DEFAULT_C == jfixed_base.DEFAULT_C == 8


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_ntt_batched_matches_jax(inverse):
    """(16, 3) Montgomery coefficients over axis 0, no 1/N scaling: the
    forward transform then the unscaled inverse give N times the input."""
    rng = random.Random(71)
    vals = [[rng.randrange(R_MOD) for _ in range(3)] for _ in range(16)]
    ja = JFR.from_int(vals)
    got = ntt.ntt_batched(to_torch(ja), inverse)
    assert np.array_equal(np.asarray(jntt.ntt_batched(ja, inverse)).astype(np.int64), got.numpy())
    back = ntt.ntt_batched(ntt.ntt_batched(to_torch(ja)), inverse=True)
    assert torch.equal(back, limb.mul(to_torch(ja), FR.from_int(16), FR))


def test_msm_takes_a_leading_group():
    """msm(g1, points, scalars, c) and msm_batched(g1, ...) as sonic_tpu's
    msm / msm_batched and golden; msm(g2, ...) as golden G2 sums; the
    port's keyword form gives the same; a group given twice raises."""
    rng = random.Random(72)
    N, c = 8, 4
    pts = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(N)]
    pts[3] = None
    sc = [[rng.randrange(R_MOD) for _ in range(N)] for _ in range(2)]
    ja = JAffine(JFQ.from_int([p[0] if p else 0 for p in pts]), JFQ.from_int([p[1] if p else 0 for p in pts]),
                 jnp.asarray([p is None for p in pts]))
    js = JFR.from_int(sc, mont=False)
    points = g1.from_host(pts, "cpu")

    def host(p, grp=g1):
        return grp.to_host(grp.to_affine(p.map(lambda a: a.reshape((-1,) + a.shape[a.dim() - grp.F.coord_ndim:]))))

    jone = jgroup.g1.to_affine(jpp.msm(jgroup.g1, ja, js[0], c))
    want = [golden.g1_msm(pts, s) for s in sc]
    assert host(pippenger.msm(g1, points, to_torch(js[0]), c)) == want[:1] == [
        None if bool(jone.inf) else (JFQ.to_int(np.asarray(jone.x)), JFQ.to_int(np.asarray(jone.y)))]
    assert host(pippenger.msm(points, to_torch(js[0]), c, group=g1)) == want[:1]
    jb = jgroup.g1.to_affine(jpp.msm_batched(jgroup.g1, ja, js, c))
    got = host(pippenger.msm_batched(g1, points, to_torch(js), c))
    assert got == want == [(int(x), int(y)) for x, y in zip(JFQ.to_int(np.asarray(jb.x)), JFQ.to_int(np.asarray(jb.y)))]
    g2pts = [golden.g2_mul(golden.G2_GEN, rng.randrange(1, R_MOD)) for _ in range(3)]
    acc = None
    for p, k in zip(g2pts, sc[0]):
        acc = golden.g2_add(acc, golden.g2_mul(p, k))
    assert host(pippenger.msm(g2, g2.from_host(g2pts, "cpu"), FR.from_int(sc[0][:3], mont=False), c), g2) == [acc]
    with pytest.raises(TypeError, match="group given twice"):
        pippenger.msm(g1, points, to_torch(js[0]), c, group=g2)
