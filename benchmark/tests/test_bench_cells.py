"""Each cell driven on the CPU at a tiny size, with the kernels' plain
versions (the harness's look for a card skipped), held to the reference;
and the faults and the control each seen to make `correct` false.

The cells' configurations are cut to n = 8 gates, q = 2 (d = 76) and
B = 2; the traffic files are the cells' own. The mesh cell runs four
gloo ranks in spawned processes.
"""
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import control, harness  # noqa: E402

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
    n, q, d = TINY["gates"], TINY["linear_constraints"], TINY["d"]
    jobs = [(0, k % 2, gen.randomness(SEED, "window", k, q)) for k in range(3)]
    assert reference.expected(SEED, n, q, d, jobs, 2) == reference.expected(SEED, n, q, d, jobs, 1)
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
