"""PyTorch port, multi-rank layer: sonic_tpu_torch.parallel (process
bring-up, meshes, the sharded MSM and NTT) and SRS.new(mesh), plus the
port's utils (sanitize, trace, log).

Each world test spawns one gloo world (2 or 4 ranks, one thread each,
`init_method="file://"` under tmp_path: no ports) that runs every check of
this file on the same inputs and writes its results to files. The parent
computes the references meanwhile, with the JAX package's single-device
functions (never with a mesh: its mesh tests sometimes abort inside
XLA:CPU) and the golden host code, and compares bit for bit: points in
affine form, field values limb for limb.

This module imports neither jax nor sonic_tpu at its top level: the ranks
import it to find their worker.
"""
import os
import random
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 600


def run_world(fn, world: int, tmp_path, *args):
    """Start `world` ranks of fn(rank, world, store, outdir, *args) with
    the spawn method and return wait: wait() joins them (a rank's
    exception fails the test with its traceback; a world that outlives
    WORLD_TIMEOUT_S is killed) and returns each rank's results (saved by
    `save_rank`), in rank order."""
    outdir = tmp_path / f"world{world}"
    outdir.mkdir()
    store = str(tmp_path / f"store{world}")
    ctx = mp.start_processes(fn, args=(world, store, str(outdir)) + args, nprocs=world,
                             join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"world of {world} ranks did not finish in {WORLD_TIMEOUT_S} s")
        return [torch.load(outdir / f"rank{r}.pt", weights_only=False) for r in range(world)]

    return wait


def init_rank(rank: int, world: int, store: str):
    """Join a gloo world of `world` ranks (one thread); returns the global mesh."""
    torch.set_num_threads(1)
    from sonic_tpu_torch.parallel import distributed

    distributed.initialize(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    return distributed.global_mesh()


def save_rank(outdir: str, rank: int, results) -> None:
    import torch.distributed as dist

    torch.save(results, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the world's checks -------------------------------------------------------------------

MSM_NS = (3, 32, 33)  # 3 < world: a rank with an empty slice
BATCH_M, BATCH_N = 5, 9
NTT_N = 64  # R = C = 8: splits over 2 and 4 ranks
SRS_D, SRS_X, SRS_ALPHA = 10, 23, 29  # tests/test_srs_sharded.py's
G2_N = 5  # msm_sharded(g2, ...): over 4 ranks, slices of 2, 2, 1 and 0 points


def _inputs():
    """Host inputs of the world's checks, the same in parent and ranks."""
    from sonic_tpu_torch import golden
    from sonic_tpu_torch.fields.constants import R_MOD

    rng = random.Random(404)

    def points(n):
        pts = [golden.g1_mul(golden.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(n)]
        pts[n // 2] = None
        return pts

    msms = [(points(n), [rng.randrange(R_MOD) for _ in range(n)]) for n in MSM_NS]
    bpts = points(BATCH_N)
    bsc = [[rng.randrange(R_MOD) for _ in range(BATCH_N)] for _ in range(BATCH_M)]
    bsc[1][3] = 0
    ntt_in = [rng.randrange(R_MOD) for _ in range(NTT_N)]
    mul_in = ([rng.randrange(R_MOD) for _ in range(40)], [rng.randrange(R_MOD) for _ in range(30)])
    g2pts = [golden.g2_mul(golden.G2_GEN, rng.randrange(1, R_MOD)) for _ in range(G2_N)]
    g2pts[1] = None
    g2sc = [rng.randrange(R_MOD) for _ in range(G2_N)]
    return msms, (bpts, bsc), ntt_in, mul_in, (g2pts, g2sc)


def _world_checks(rank, world, store, outdir):
    mesh = init_rank(rank, world, store)
    from sonic_tpu_torch.curve.group import g1, g2
    from sonic_tpu_torch.fields.limb import FR
    from sonic_tpu_torch.msm import pippenger
    from sonic_tpu_torch.parallel import distributed, mesh as pmesh, ntt_sharded
    from sonic_tpu_torch.srs import SRS

    out = {}
    # meshes: the global one, and (nodes, ranks per node) with 2 ranks a node
    os.environ["LOCAL_WORLD_SIZE"] = str(min(2, world))
    two_d = distributed.host_slice_mesh()
    local = distributed.local_mesh()
    out["meshes"] = (mesh.mesh_dim_names, mesh.size(), mesh.get_local_rank(),
                     two_d.mesh_dim_names, tuple(two_d.mesh.shape),
                     local.size(), local.mesh.tolist())
    # MSMs: one per n, a batched one, msm_windows + combine_windows
    msms, (bpts, bsc), ntt_in, mul_in, (g2pts, g2sc) = _inputs()
    got = []
    for i, (pts, sc) in enumerate(msms):
        args = (g1.from_host(pts, "cpu"), FR.from_int(sc, mont=False), mesh)
        p = pmesh.msm_sharded(g1, *args) if i == 0 else pmesh.msm_sharded(*args)  # both orders
        got.append(g1.to_host(g1.to_affine(p.map(lambda a: a.reshape(1, -1))))[0])
    P, S = g1.from_host(bpts, "cpu"), FR.from_int(bsc, mont=False)
    got.append(g1.to_host(g1.to_affine(pippenger.msm_batched(P, S, mesh=mesh))))
    part = pippenger.msm_windows(P, S, mesh=mesh)
    got.append(g1.to_host(g1.to_affine(pippenger.combine_windows([part])[0])))
    out["msm"] = got
    p = pmesh.msm_sharded(g2, g2.from_host(g2pts, "cpu"), FR.from_int(g2sc, mont=False), mesh, 4)
    out["msm_g2"] = g2.to_host(g2.to_affine(p.map(lambda a: a[None])))[0]
    out["totals"] = torch.stack(list(part.totals))  # the same projective values on every rank
    # NTTs
    a = FR.from_int(ntt_in)
    out["ntt"] = ntt_sharded.ntt_sharded(a, mesh)
    out["intt"] = ntt_sharded.ntt_sharded(a, mesh, inverse=True)
    out["roundtrip"] = ntt_sharded.ntt_sharded(out["ntt"], mesh, inverse=True)
    out["mul"] = ntt_sharded.poly_mul_ntt_sharded(FR.from_int(mul_in[0]), FR.from_int(mul_in[1]), mesh)
    # SRS, both modes
    for mode in ("full", "verifier"):
        srs = SRS.new(SRS_D, SRS_X, SRS_ALPHA, h_mode=mode, device="cpu", mesh=mesh)
        out[f"srs_{mode}"] = {name: None if getattr(srs, name) is None else tuple(getattr(srs, name))
                              for name in ("g_x", "g_ax", "h_x", "h_ax")}
    save_rank(outdir, rank, out)


@pytest.mark.parametrize("world", [2, 4])
def test_world_matches_single_device_jax(world, tmp_path):
    wait = run_world(_world_checks, world, tmp_path)

    import jax.numpy as jnp
    from sonic_tpu import golden
    from sonic_tpu.curve.group import Affine as JAffine
    from sonic_tpu.curve.group import g1 as jg1
    from sonic_tpu.fields.limb import FQ as JFQ
    from sonic_tpu.fields.limb import FR as JFR
    from sonic_tpu.msm import pippenger as jpp
    from sonic_tpu.poly import ntt as jntt
    from sonic_tpu.srs import SRS as JSRS

    def jax_points(pts):
        return JAffine(JFQ.from_int([p[0] if p else 0 for p in pts]),
                       JFQ.from_int([p[1] if p else 0 for p in pts]),
                       jnp.asarray([p is None for p in pts]))

    def jax_host(aff):
        xs = np.atleast_1d(JFQ.to_int(np.asarray(aff.x).reshape(-1, JFQ.nlimbs)))
        ys = np.atleast_1d(JFQ.to_int(np.asarray(aff.y).reshape(-1, JFQ.nlimbs)))
        infs = np.asarray(aff.inf).reshape(-1).tolist()
        return [None if f else (int(x), int(y)) for x, y, f in zip(xs, ys, infs)]

    def limbs(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))

    msms, (bpts, bsc), ntt_in, mul_in, (g2pts, g2sc) = _inputs()
    want_g2 = None
    for p, k in zip(g2pts, g2sc):
        want_g2 = golden.g2_add(want_g2, None if p is None else golden.g2_mul(p, k))
    want_msm = []
    for pts, sc in msms:
        want = golden.g1_msm(pts, sc)
        assert jax_host(jg1.to_affine(jpp.msm_g1(jax_points(pts), JFR.from_int(sc, mont=False))))[0] == want
        want_msm.append(want)
    want_b = [golden.g1_msm(bpts, s) for s in bsc]
    assert jax_host(jg1.to_affine(jpp.msm_batched(jg1, jax_points(bpts), JFR.from_int(bsc, mont=False)))) == want_b
    want_msm += [want_b, want_b]
    a = JFR.from_int(ntt_in)
    want_ntt = {"ntt": limbs(jntt.ntt(a)), "intt": limbs(jntt.ntt(a, inverse=True)), "roundtrip": limbs(a),
                "mul": limbs(jntt.poly_mul_ntt(JFR.from_int(mul_in[0]), JFR.from_int(mul_in[1])))}
    want_srs = {mode: JSRS.new(SRS_D, x=SRS_X, alpha=SRS_ALPHA, h_mode=mode) for mode in ("full", "verifier")}

    ranks = wait()
    for rank, out in enumerate(ranks):
        assert out["meshes"] == (("shard",), world, rank, ("dcn", "ici"), (world // 2, 2), 2,
                                 [rank // 2 * 2, rank // 2 * 2 + 1])
        assert out["msm"] == want_msm
        assert out["msm_g2"] == want_g2
        assert torch.equal(out["totals"], ranks[0]["totals"])
        for key, want in want_ntt.items():
            assert torch.equal(out[key], want), key
        for mode, jsrs in want_srs.items():
            for name, table in out[f"srs_{mode}"].items():
                jt = getattr(jsrs, name)
                if jt is None:
                    assert table is None, (mode, name)
                    continue
                x, y, inf = table
                assert torch.equal(x, limbs(jt.x)) and torch.equal(y, limbs(jt.y)), (mode, name)
                assert torch.equal(inf, torch.from_numpy(np.array(jt.inf))), (mode, name)


# -- process bring-up in one process --------------------------------------------------------


@pytest.fixture
def init_calls(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    return calls


def test_initialize_single_process_is_a_noop(init_calls):
    from sonic_tpu_torch.parallel import distributed

    distributed.initialize()
    distributed.initialize(world_size=1)
    assert init_calls == []


def test_initialize_passes_the_torchrun_environment(init_calls, monkeypatch):
    from sonic_tpu_torch.parallel import distributed

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    distributed.initialize()
    distributed.initialize(backend="nccl", init_method="file:///tmp/x", world_size=2, rank=1)
    # every group gets the module's timeout, past NCCL's 10-minute default
    t = distributed.TIMEOUT
    assert t.total_seconds() > 600
    assert init_calls == [
        (("gloo",), {"init_method": "env://", "world_size": 4, "rank": 2, "timeout": t}),
        (("nccl",), {"init_method": "file:///tmp/x", "world_size": 2, "rank": 1, "timeout": t}),
    ]


@pytest.mark.parametrize("backend, world, local, cards, device", [
    ("nccl", 4, 2, 4, 2),  # a card a rank
    ("nccl", 4, 0, 2, None),  # more ranks than cards: refused on every rank
    ("nccl", 2, 1, 1, None),
    ("gloo", 2, 1, 1, 0),  # gloo ranks share the card (chip_smoke.py phase 9)
])
def test_initialize_gives_nccl_a_card_a_rank(init_calls, monkeypatch, backend, world, local, cards, device):
    from sonic_tpu_torch.parallel import distributed

    devices = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", str(local))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    if device is None:
        with pytest.raises(RuntimeError, match="NCCL takes one card a rank"):
            distributed.initialize(backend=backend)
        assert init_calls == [] and devices == []
    else:
        distributed.initialize(backend=backend)
        assert devices == [device]
        assert init_calls == [((backend,), {"init_method": "env://", "world_size": world, "rank": local,
                                            "timeout": distributed.TIMEOUT})]


def test_splittable_follows_the_four_step_split():
    from sonic_tpu_torch.parallel.ntt_sharded import splittable

    # N = 64 = 8 x 8; N = 32 = 4 x 8; N = 8192 = 64 x 128 (the n=1024 t product)
    assert splittable(64, 4) and splittable(40 + 30 - 1, 8) and not splittable(64, 16)
    assert splittable(32, 4) and not splittable(32, 8)
    assert splittable(3, 2) and not splittable(3, 4)


# -- utils --------------------------------------------------------------------------------


def _sanitize_cases():
    from sonic_tpu_torch.fields import constants as C
    from sonic_tpu_torch.fields.limb import FQ, FR

    fr = FR.from_int([1, 2, FR.modulus - 1]).numpy()
    big = np.zeros((1, FR.nlimbs), np.int64)
    big[0, 0] = 1 << 20
    over = np.array([C.int_to_limbs(FQ.modulus, FQ.nlimbs)], np.int64)
    return [
        ("Fr", fr, None),
        ("Fr", big, "non-canonical limb"),
        ("Fq", over, "modulus"),
        ("Fr", np.zeros((2, 7), np.int64), "limb axis"),
    ]


@pytest.mark.parametrize("case", range(4))
def test_sanitize_accepts_and_rejects_as_the_reference(case):
    from sonic_tpu.fields.limb import FQ as JFQ
    from sonic_tpu.fields.limb import FR as JFR
    from sonic_tpu.utils.sanitize import assert_canonical as jassert
    from sonic_tpu_torch.fields.limb import FQ, FR
    from sonic_tpu_torch.utils import sanitize

    field, arr, match = _sanitize_cases()[case]
    spec, jspec = (FR, JFR) if field == "Fr" else (FQ, JFQ)
    for check, a, s in ((jassert, arr.astype(np.uint32), jspec),
                        (sanitize.assert_canonical, torch.from_numpy(arr), spec)):
        if match is None:
            check(a, s, "value")
        else:
            with pytest.raises(AssertionError, match=match):
                check(a, s, "value")


def test_sanitize_debug_check_follows_the_environment(monkeypatch):
    from sonic_tpu_torch.fields.limb import FR
    from sonic_tpu_torch.utils import sanitize

    bad = torch.full((1, FR.nlimbs), -1, dtype=torch.int64)
    monkeypatch.delenv("SONIC_TPU_DEBUG", raising=False)
    sanitize.debug_check_canonical(bad, FR)
    monkeypatch.setenv("SONIC_TPU_DEBUG", "1")
    with pytest.raises(AssertionError, match="non-canonical limb"):
        sanitize.debug_check_canonical(bad, FR)


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    import json

    from sonic_tpu_torch.fields import limb
    from sonic_tpu_torch.fields.limb import FR
    from sonic_tpu_torch.utils.trace import device_trace, span

    monkeypatch.delenv("SONIC_TPU_TRACE_DIR", raising=False)
    with device_trace():  # no directory: no trace
        pass
    a = FR.from_int([3, 4, 5])
    with device_trace(str(tmp_path)):
        with span("sonic.test_span"):
            limb.mul(a, a, FR)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sonic.test_span" for e in events)


def test_srs_new_logs_its_phases(monkeypatch, capsys):
    import json

    from sonic_tpu_torch.srs import SRS

    monkeypatch.setenv("SONIC_TPU_LOG", "json")
    SRS.new(2, 5, 7, h_mode="full", device="cpu")
    recs = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    assert [(r["logger"], r["event"]) for r in recs] == [
        ("srs", "srs.powers"), ("srs", "srs.G1"), ("srs", "srs.G2")]
    assert recs[0]["d"] == 2 and recs[1]["rows"] == 5 and all(r["seconds"] >= 0 for r in recs)
