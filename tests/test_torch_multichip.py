"""PyTorch port under its launcher: `python -m torch.distributed.run
--standalone --nproc_per_node=2 -m <module> --device cpu ...` for
sonic_tpu_torch.multichip, sonic_tpu_torch.example and
sonic_tpu_torch.breakdown, two gloo ranks on the CPU.

multichip runs all its paths at a tiny size: a full SRS at d = 12, the
prove at n=8, q=2 under SONIC_TPU_NTT_THRESHOLD=512, where the t(X, y)
product takes the four-step sharded NTT (as the JAX package's multichip
dry run, `_dryrun_impl`, does), on the d = 7n + 20 SRS of its own path,
built in verifier mode (`--prove-srs verifier`, as BASELINE config 4's
run at n = 2^20 proves). It must exit 0, report
every path equal on both ranks to rank 0's single-rank call, and its proof
digest must equal that of `sonic_tpu.golden_protocol.prove` on the same
inputs, computed here while the ranks run. example and breakdown must
prove with the mesh of both ranks.

`--standalone` makes the launcher pick a free local port, so test workers
running side by side do not collide.
"""
import hashlib
import json
import os
import random
import signal
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, Q, SEED = 8, 2, 77

ARGS = {
    "multichip": ["--srs-d", "12", "--gates", str(N), "--q", str(Q), "--seeds", str(SEED), "--ntt", "6",
                  "--batch", "2", "--batch-gates", "1", "--batch-q", "1", "--reps", "0",
                  "--prove-srs", "verifier"],
    "example": ["--gates", str(N), "--q", str(Q), "--seed", "3"],
    "breakdown": ["--gates", str(N), "--q", str(Q), "--reps", "1"],
}


def _golden_proof_digest() -> str:
    """sha256 of the golden proof of multichip's prove path: its circuit,
    trapdoor and randomness drawn from Random(SEED) in the same order."""
    from sonic_tpu import golden_protocol as jgp
    from sonic_tpu import serial as jserial
    from sonic_tpu.circuit import random_circuit

    rng = random.Random(SEED)
    circuit, assignment = random_circuit(rng, n=N, q=Q)
    x, alpha = rng.randrange(2, jgp.P), rng.randrange(2, jgp.P)
    rnd = jgp.Randomness.generate(rng, m=Q)
    proof, _ = jgp.prove(jgp.SRS.new(7 * N + 20, x=x, alpha=alpha), assignment, circuit, rnd)
    return hashlib.sha256(jserial.proof_to_bytes(proof)).hexdigest()


@pytest.mark.parametrize("module", list(ARGS))
def test_launcher_runs_the_port_on_two_ranks(module):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", SONIC_TPU_NTT_THRESHOLD="512")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", f"sonic_tpu_torch.{module}", "--device", "cpu", *ARGS[module]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        want = _golden_proof_digest() if module == "multichip" else None
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    if module == "example":
        assert out.count("Success: True") == 2
    elif module == "breakdown":
        assert "on cpu, 2 ranks: prove s" in out
        assert "in comms: all_to_all_single (NTT)" in out
    else:
        lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        assert lines[-1]["ok"] is True and lines[-1]["n_devices"] == 2 and lines[-1]["backend"] == "gloo"
        paths = lines[:-1]
        assert [p["path"] for p in paths] == ["srs", "srs", "prove", "ntt", "batch"]
        assert all(p["equal"] is True and p["K"] == 2 for p in paths)
        assert [(p["d"], p["h_mode"]) for p in paths[:2]] == [(12, "full"), (7 * N + 20, "verifier")]
        assert all(len(p["ranks_median_min_s"]) == 2 for p in paths)
        prove = paths[2]
        assert (prove["n"], prove["q"], prove["d"]) == (N, Q, 7 * N + 20)
        assert prove["digest"] == want
        assert prove["verify"] is True and prove["tampered_verify"] is False
        # the t product went through the four-step sharded NTT, as did the ntt path's
        assert prove["four_step_products"] == 1 and paths[3]["four_step_products"] == 1
