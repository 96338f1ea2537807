"""Each cell driven on the CPU at a tiny size, with the kernels' plain
versions (the harness's look for a card skipped), held to the reference;
and the faults and the control each seen to make `correct` false.

The cells' configurations are cut to n = 8 gates, q = 2 (d = 76) and
B = 2; the traffic files are the cells' own. The mesh cell runs four
gloo ranks in spawned processes. A configuration that names another
circuit family (the test family in `circuits/`: Q > n, empty rows and
rows of several entries, weights P - 1, and m != q) runs from its own
BENCHMARK.json and config file, with its own upload and with the default.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import control, gen, harness  # noqa: E402

TINY = {"gates": 8, "linear_constraints": 2, "d": 76}
SEED = 2**31 + 977


def _spec(workload):
    spec = harness.load_spec(workload)
    spec.config.update(TINY, batch=2 if spec.config.get("batch", 1) > 1 else 1)
    return spec


def _run(workload, **kw):
    torch.set_num_threads(1)
    return harness.run_cell(_spec(workload), SEED, 0.0, False, "cpu", workers=1, **kw)


@pytest.mark.parametrize("workload", ["prove.n16q64", "batch.n16q8.b16"])
def test_cell_runs_correct_on_the_cpu(workload):
    res = _run(workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res
    spec = harness.load_spec(workload)
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"



def test_the_reference_workers_agree_and_all_end(monkeypatch):
    import subprocess

    from benchmark import gen, reference

    started = []

    class Popen(subprocess.Popen):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)

    monkeypatch.setattr(reference.subprocess, "Popen", Popen)
    config = _spec("prove.n16q64").config
    jobs = [(0, k % 2, gen.randomness(SEED, "window", k, TINY["linear_constraints"])) for k in range(3)]
    assert reference.expected(SEED, config, jobs, 2) == reference.expected(SEED, config, jobs, 1)
    assert len(started) == 2 and all(p.returncode == 0 for p in started)

def test_a_traced_run_reads_no_device_metric_from_the_cpu():
    torch.set_num_threads(1)
    with pytest.raises(RuntimeError, match="CUDA card"):
        harness.run_cell(_spec("prove.n16q64"), SEED, 0.0, True, "cpu", workers=1)


def _alter_first_point(monkeypatch):
    from sonic_tpu_torch import protocol

    real = protocol.jacobians_to_host

    def altered(p):
        pts = real(p)
        x, y = pts[0]
        pts[0] = (x, (-y) % 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB)
        return pts

    monkeypatch.setattr(protocol, "jacobians_to_host", altered)


@pytest.mark.parametrize("workload", ["prove.n16q64", "batch.n16q8.b16"])
def test_an_answer_altered_where_it_is_made_is_not_correct(workload, monkeypatch):
    _alter_first_point(monkeypatch)
    res = _run(workload)
    assert not res["correct"] and res["checks"]["mismatched_elements"]["value"] >= 1
    if workload == "prove.n16q64":
        assert res["checks"]["verify_false"]["value"] >= 1


FAMILY = {"gates": 16, "linear_constraints": 40, "d": 132, "circuit": "mixed_sparse", "helper_instances": 3}


def _family_spec(tmp_path, monkeypatch, traffic, own_upload):
    """A checkout whose BENCHMARK.json holds one cell of a config file that
    names the test family, with the family's files where the loader looks."""
    circuits = tmp_path / "circuits"
    circuits.mkdir()
    for f in ["mixed_sparse.py"] + ["mixed_sparse.upload.py"] * own_upload:
        shutil.copy(os.path.join(HERE, "circuits", f), circuits)
    monkeypatch.setattr(gen, "CIRCUITS", str(circuits))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (tmp_path / "mixed.json").write_text(json.dumps(dict(harness.load_spec("prove.n16q64").config, **FAMILY)))
    bench["configs"] = [{"name": "mixed", "source": "tests", "file": "mixed.json", "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": "prove.mixed", "config": "mixed", "traffic": traffic, "chips": 1, "why": "tests"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.load_spec("prove.mixed", root=str(tmp_path))


@pytest.mark.parametrize("own_upload", [True, False], ids=["own_upload", "default_upload"])
def test_a_config_that_names_another_family_runs_correct(own_upload, tmp_path, monkeypatch):
    spec = _family_spec(tmp_path, monkeypatch, "prove_verify", own_upload)
    rows = gen.family(spec.config).rows(SEED, 0, spec.config)
    widths = np.concatenate([np.diff(r.indptr) for r in rows])
    weights = set(np.concatenate([r.vals for r in rows]).tolist())
    assert rows[0].q > rows[0].n and (widths == 0).any() and (widths > 1).any()
    assert gen.P - 1 in weights and 2 in weights
    assert gen.helper_instances(spec.config) != spec.config["linear_constraints"]
    assert (harness.load_upload(spec.config) is harness.upload_dense) is not own_upload
    torch.set_num_threads(1)
    res = harness.run_cell(spec, SEED, 0.0, False, "cpu", workers=1)
    # mismatched_elements counts a proof of another length than 6m + 12
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    assert res["checks"]["verify_false"]["value"] == 0 and "setup_s" in res["metrics"]


def test_an_answer_altered_in_a_family_cell_is_not_correct(tmp_path, monkeypatch):
    spec = _family_spec(tmp_path, monkeypatch, "prove", False)
    _alter_first_point(monkeypatch)
    torch.set_num_threads(1)
    res = harness.run_cell(spec, SEED, 0.0, False, "cpu", workers=1)
    assert not res["correct"] and res["checks"]["mismatched_elements"]["value"] >= 1


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from sonic_tpu_torch import protocol

    real = protocol.prove_batch

    def half(srs, das, dcs, rnds, mesh=None):
        k = len(das) // 2
        out = real(srs, das[:k], dcs[:k], rnds[:k], mesh=mesh)
        return out + out[: len(das) - k]

    monkeypatch.setattr(protocol, "prove_batch", half)
    res = _run("batch.n16q8.b16")
    assert not res["correct"] and res["failed"] >= 1


def test_the_control_blinding_off_is_not_correct():
    res = _run("prove.n16q64", to_program=control.blinding_off)
    # pr_r, pr_t, pr_a, pr_wa, pr_b, pr_wb, pr_wt of every proof
    assert not res["correct"]
    assert res["checks"]["mismatched_elements"]["value"] == 7 * res["attempted"]
    assert res["checks"]["verify_false"]["value"] == 0  # the proofs still verify


def _rank(rank, world, init, out, fault):
    torch.set_num_threads(1)
    from sonic_tpu_torch.parallel import distributed

    distributed.initialize(backend="gloo", init_method=init, world_size=world, rank=rank)
    if fault:
        from sonic_tpu_torch.parallel import mesh as pmesh

        pmesh.sum_over_ranks = lambda totals, mesh: totals  # the exchange between chips left out
    mesh = distributed.global_mesh()
    res = harness.run_cell(_spec("prove.n16q64.mesh4"), SEED, 0.0, False, "cpu", mesh, workers=1)
    if res is not None:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "exchange_left_out"])
def test_the_mesh_cell_on_four_gloo_ranks(fault, tmp_path):
    out = tmp_path / "result.json"
    torch.multiprocessing.start_processes(_rank, args=(4, f"file://{tmp_path}/init", str(out), fault),
                                          nprocs=4, start_method="spawn")
    with open(out) as f:
        res = json.load(f)
    assert res["correct"] is (not fault), res["checks"]
    assert set(res["metrics"]) == {"setup_s", "prove_s"}


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """On a machine with a card: run.py end to end, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess

    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "prove.n16q64", "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
