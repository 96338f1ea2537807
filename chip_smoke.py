#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sonic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both CUDA kernels (csrc/ -> sonic_tpu_torch/_build/) and the native
pairing library (native/pairing.cpp), then runs, each phase timed after
torch.cuda.synchronize():

  1. card     the device name and `nvidia-smi` name and power limit;
  2. kernel 1 Montgomery multiply, Fr and Fq, 2^20 random canonical
              elements plus 0, 1 and N-1: equal to mont_mul_plain;
  3. kernel 2 bucket accumulation at K=128, T=64, c=8 with infinities and
              negative digits (also against accumulate_plain on CPU copies,
              plain torch throughout), and at the 2^16-point MSM's own
              layout: the whole bucket grid equal to accumulate_plain; then
              a full 2^16-point MSM equal to the native host Pippenger;
  4. vectors  example1/example2 of tests/vectors/pinned_v1.json: the proof
              bytes equal `proof_hex`, verify True, False after tampering;
  5. main path random_circuit(Random(42), n=1024, q=64), d = 7n+20: SRS.new
              on the card, one warm-up and three timed proofs, verify True
              and False after tampering, pr_r / pr_t equal to native host
              MSMs over the SRS rows, and both kernels' launch counts. Every
              scan launch of the counted prove (the helper's batched ones at
              M=64 included) and the first kernel-1 launch of each distinct
              operand shape are kept and then held, output for output,
              against accumulate_plain / mont_mul_plain on the same inputs.

Every comparison is exact (all values are integers); a failed one raises.
The line before last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script fails before printing
any result.
"""
from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from sonic_tpu_torch import golden, kernels, native, protocol, serial
    from sonic_tpu_torch import golden_protocol as gp
    from sonic_tpu_torch.circuit import example_circuit_1, example_circuit_2, random_circuit
    from sonic_tpu_torch.constraints import (
        DeviceAssignment, DeviceCircuit, k_at_y, r_at_y, r_x1_poly, s_at_y,
    )
    from sonic_tpu_torch.curve.group import Affine, g1
    from sonic_tpu_torch.fields import limb, mont_mul
    from sonic_tpu_torch.fields.limb import FQ, FR
    from sonic_tpu_torch.msm import bucket_acc, pippenger
    from sonic_tpu_torch.poly import laurent
    from sonic_tpu_torch.srs import SRS

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev)
    gen.manual_seed(20240601)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def event_ms(fn, reps):
        fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def rand_canonical(spec, n):
        """n random canonical limb vectors (top limb below the modulus's)."""
        x = torch.randint(0, 1 << 16, (n, spec.nlimbs), generator=gen, device=dev)
        x[:, -1] = torch.randint(0, spec.mod_limbs[-1], (n,), generator=gen, device=dev)
        return x

    # -- set-up: builds ----------------------------------------------------------
    _, t_build = timed(kernels.build)
    log(f"setup: CUDA kernels built in {t_build:.1f} s ({kernels.build()})")
    for line in kernels.build_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native pairing library did not build or load")
    log(f"setup: native pairing library built and loaded in {time.perf_counter() - t0:.1f} s")

    # -- phase 1: card ---------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1 card: torch sees {name!r}, {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # -- phase 2: kernel 1 ---------------------------------------------------------------
    k1 = {}
    for spec in (FR, FQ):
        n = 1 << 20
        edge = torch.tensor([[0] * spec.nlimbs, [1] + [0] * (spec.nlimbs - 1), list(spec.mod_limbs)],
                            dtype=torch.int64, device=dev)
        edge[2, 0] -= 1  # N - 1 (the modulus is odd)
        a = torch.cat([rand_canonical(spec, n), edge])
        b = torch.cat([rand_canonical(spec, n), edge.flip(0)])
        got = mont_mul.mont_mul(a, b, spec)
        want = mont_mul.mont_mul_plain(a, b, spec)
        sync()
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel 1 {spec.name}: {int((got != want).any(-1).sum())} elements differ")
        ms = event_ms(lambda: mont_mul.mont_mul(a, b, spec), 20)
        plain_ms = event_ms(lambda: mont_mul.mont_mul_plain(a, b, spec), 3)
        k1[spec.name] = (err, ms, plain_ms)
        log(f"phase 2 kernel 1 {spec.name}: {n + 3} products equal to mont_mul_plain "
            f"(max abs err {err}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # -- phase 3: kernel 2 ---------------------------------------------------------------
    N = 1 << 16
    base = g1.from_affine(g1.generator(dev))
    (aff, t_pts) = timed(lambda: g1.to_affine(g1.scalar_mul(base, rand_canonical(FR, N))))
    inf = torch.zeros(N, dtype=torch.bool, device=dev)
    inf[::37] = True
    points = Affine(aff.x, aff.y, inf)
    log(f"phase 3 kernel 2: {N} G1 points made on the card in {t_pts:.1f} s")

    def check_grid(pts, digits, nb, label, time_it=True):
        got = bucket_acc.accumulate(pts, digits, nb)
        want = bucket_acc.accumulate_plain(pts, digits, nb)
        sync()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"kernel 2 {label}: bucket grid differs from accumulate_plain")
        if not time_it:
            log(f"  kernel 2 {label}: grid {tuple(got.x.shape)} equal to accumulate_plain "
                f"(max abs err {err})")
            return err, None, None
        ms = event_ms(lambda: bucket_acc.accumulate(pts, digits, nb), 5)
        plain_ms = event_ms(lambda: bucket_acc.accumulate_plain(pts, digits, nb), 1)
        log(f"  kernel 2 {label}: grid {tuple(got.x.shape)} equal to accumulate_plain "
            f"(max abs err {err}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        return err, ms, plain_ms

    K, T, c = 128, 64, 8
    W, nb = 256 // c + 1, (1 << (c - 1)) + 1
    small = Affine(points.x[: K * T].reshape(K, T, -1), points.y[: K * T].reshape(K, T, -1),
                   points.inf[: K * T].reshape(K, T))
    digits = torch.randint(-(nb - 1), nb, (K, T, W), generator=gen, device=dev)
    k2_err = [check_grid(small, digits, nb, f"K={K} T={T} c={c}")[0]]
    # on the CPU, accumulate_plain's products are mont_mul_plain's, so this
    # oracle involves no kernel at all
    cpu = bucket_acc.accumulate_plain(Affine(*(a.cpu() for a in small)), digits.cpu(), nb)
    got = bucket_acc.accumulate(small, digits, nb)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, cpu)):
        raise AssertionError("kernel 2: bucket grid differs from accumulate_plain on the CPU")
    log(f"  kernel 2 K={K} T={T} c={c}: grid equal to accumulate_plain on CPU copies")

    scalars = rand_canonical(FR, N)
    lay_pts, lay_digits, c_msm, nb_msm = pippenger._lay_out(points, scalars, 1, None, None)
    k2_err.append(check_grid(lay_pts, lay_digits, nb_msm, f"2^16-point MSM layout c={c_msm}")[0])

    res, t_msm = timed(lambda: g1.to_affine(pippenger.msm(points, scalars)))
    got = None if bool(res.inf) else (FQ.to_int(res.x), FQ.to_int(res.y))
    xs, ys = FQ.to_int(points.x), FQ.to_int(points.y)
    infs = points.inf.tolist()
    host_pts = [None if infs[i] else (int(xs[i]), int(ys[i])) for i in range(N)]
    host_sc = [int(v) for v in FR.to_int(scalars, mont=False)]
    if not all(golden.g1_is_on_curve(p) for p in host_pts[:64] if p is not None):
        raise AssertionError("generated points are not on the curve")
    t0 = time.perf_counter()
    want = native.g1_msm_native(host_pts, host_sc)
    t_native = time.perf_counter() - t0
    if got != want:
        raise AssertionError("2^16-point MSM differs from the native host Pippenger")
    log(f"phase 3 msm: 2^16 points equal to native g1_msm_native; card {t_msm:.3f} s "
        f"(first call), host native {t_native:.3f} s")

    # -- phase 4: pinned vectors -----------------------------------------------------------
    with open(os.path.join(ROOT, "tests", "vectors", "pinned_v1.json")) as f:
        vectors = json.load(f)
    makers = {"example1": example_circuit_1, "example2": example_circuit_2}
    for vname in ("example1", "example2"):
        vec = vectors[vname]
        r = vec["rnd"]
        rnd = gp.Randomness(cns=r["cns"], y=r["y"], z=r["z"], ys=r["ys"], zs=r["zs"], u=r["u"], v=r["v"])
        circuit, assignment = makers[vname](x=1, z=2)
        srs = SRS.from_host(gp.SRS.new(vec["d"], x=vec["x"], alpha=vec["alpha"]), device=dev)
        dc = DeviceCircuit.from_host(circuit, device=dev)
        (proof, oracle), t_prove = timed(
            lambda: protocol.prove(srs, DeviceAssignment.from_host(assignment, device=dev), dc, rnd)
        )
        if serial.proof_to_bytes(proof).hex() != vec["proof_hex"]:
            raise AssertionError(f"{vname}: proof bytes differ from pinned_v1.json")
        if not protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
            raise AssertionError(f"{vname}: verify returned False")
        proof.pr_a = (proof.pr_a + 1) % gp.P
        if protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
            raise AssertionError(f"{vname}: tampered proof verified")
        log(f"phase 4 {vname}: proof bytes equal pinned_v1.json, verify True, tampered False "
            f"(prove {t_prove:.2f} s)")

    # -- phase 5: main path, BASELINE config 2 ------------------------------------------------
    n, q = 1024, 64
    rng = random.Random(42)
    circuit, assignment = random_circuit(rng, n=n, q=q)
    d = 7 * n + 20
    x, alpha = rng.randrange(2, gp.P), rng.randrange(2, gp.P)
    srs, t_srs = timed(lambda: SRS.new(d, x, alpha, h_mode="verifier", n_hints=[n], device=dev))
    (dc, da), t_up = timed(lambda: (DeviceCircuit.from_host(circuit, device=dev),
                                    DeviceAssignment.from_host(assignment, device=dev)))
    rnd = gp.Randomness.generate(rng, m=q)
    log(f"phase 5 main path: n={n} q={q} d={d}; SRS.new (verifier mode, G1 tables on the card) "
        f"{t_srs:.2f} s, circuit upload {t_up:.2f} s")

    # Keep the inputs of every scan launch and of the first kernel-1 launch
    # of each operand shape, to hold them against the plain versions below.
    scans, products = [], {}
    real_scan, real_mul = pippenger.accumulate, mont_mul.mont_mul

    def scan_kept(pts, digits, nb):
        scans.append((pts, digits, nb))
        return real_scan(pts, digits, nb)

    def mul_kept(a, b, spec):
        products.setdefault((spec.name, tuple(a.shape), tuple(b.shape)), (a, b, spec))
        return real_mul(a, b, spec)

    pippenger.accumulate, mont_mul.mont_mul = scan_kept, mul_kept
    mont_mul.launches = 0
    bucket_acc.launches = 0
    try:
        (proof, oracle), t_warm = timed(lambda: protocol.prove(srs, da, dc, rnd))
        ok, t_verify = timed(lambda: protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs))
    finally:
        pippenger.accumulate, mont_mul.mont_mul = real_scan, real_mul
    launches = {"mont_mul": mont_mul.launches, "bucket_acc": bucket_acc.launches}
    log(f"phase 5 prove (warm-up) {t_warm:.2f} s, verify {t_verify:.3f} s; "
        f"kernel launches in prove + verify: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    if not ok:
        raise AssertionError("main path: verify returned False")
    backend = "native C++ (sonic_tpu_torch/_build)" if native.get_lib() is not None else "pure Python"
    times = []
    for _ in range(3):
        (proof2, _), t = timed(lambda: protocol.prove(srs, da, dc, rnd))
        times.append(t)
    if serial.proof_to_bytes(proof2) != serial.proof_to_bytes(proof):
        raise AssertionError("main path: repeated proofs differ")
    log(f"phase 5 prove x3: median {statistics.median(times):.3f} s, min {min(times):.3f} s "
        f"({', '.join(f'{t:.3f}' for t in times)}); verify {t_verify:.3f} s via {backend} pairing")

    # pr_r and pr_t recomputed on the host: native MSM over the SRS rows
    def host_rows(tab, start, length):
        sl = slice(start, start + length)
        hx, hy = FQ.to_int(tab.x[sl]), FQ.to_int(tab.y[sl])
        hinf = tab.inf[sl].tolist()
        return [None if hinf[i] else (int(hx[i]), int(hy[i])) for i in range(length)]

    def host_commit(maxm, poly):
        lo = poly.offset + d - maxm
        coeffs = [int(v) for v in FR.to_int(poly.coeffs)]
        return native.g1_msm_native(host_rows(srs.g_ax, lo + d, poly.length), coeffs)

    cns = FR.from_int(rnd.cns, device=dev)
    y_m = FR.from_int(rnd.y, device=dev)
    r1 = r_x1_poly(da, cns)
    t_y = laurent.mul(r1, laurent.add(r_at_y(r1, y_m), s_at_y(dc, y_m)))
    tc = t_y.coeffs.clone()
    tc[-t_y.offset] = limb.sub(tc[-t_y.offset], k_at_y(dc, n, y_m), FR)
    if host_commit(n, r1) != proof.pr_r:
        raise AssertionError("pr_r differs from the native host MSM")
    if host_commit(d, laurent.Laurent(t_y.offset, tc)) != proof.pr_t:
        raise AssertionError("pr_t differs from the native host MSM")
    proof.pr_a = (proof.pr_a + 1) % gp.P
    if protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs):
        raise AssertionError("main path: tampered proof verified")
    log("phase 5 checks: verify True, tampered False, pr_r and pr_t equal to native host MSMs")

    # the kernels at the main path's own shapes, against their plain versions
    k1_err = [k1["Fr"][0], k1["Fq"][0]]
    for a, b, spec in products.values():
        got, want = mont_mul.mont_mul(a, b, spec), mont_mul.mont_mul_plain(a, b, spec)
        k1_err.append(int((got - want).abs().max()) if got.numel() else 0)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel 1 {spec.name} {tuple(a.shape)} x {tuple(b.shape)}: "
                                 "differs from mont_mul_plain")
    log(f"phase 5 kernel 1: the first launch of each of {len(products)} operand shapes of the "
        f"counted run equal to mont_mul_plain (max abs err {max(k1_err[2:], default=0)})")
    log(f"phase 5 kernel 2: the {len(scans)} scan launches of the counted run:")
    k2_main = None
    for i, (pts, digits, nb) in enumerate(scans):
        label = f"launch {i} digits {tuple(digits.shape)} B={nb}"
        # time the first launch of the largest shape: the helper's batched scan
        time_it = k2_main is None and digits.numel() == max(s[1].numel() for s in scans)
        err, ms, plain_ms = check_grid(pts, digits, nb, label, time_it)
        k2_err.append(err)
        if time_it:
            k2_main = (ms, plain_ms)

    kernels_line = {"kernels": [
        {"name": "mont_mul", "route": "cuda", "source": "sonic_tpu_torch/csrc/mont_mul.cu",
         "replaces": "sonic_tpu/fields/pallas_mul.py:147", "launches": launches["mont_mul"],
         "max_abs_err": max(k1_err), "ms": k1["Fq"][1], "plain_ms": k1["Fq"][2]},
        {"name": "bucket_acc", "route": "cuda", "source": "sonic_tpu_torch/csrc/bucket_acc.cu",
         "replaces": "sonic_tpu/msm/pallas_acc.py:136", "launches": launches["bucket_acc"],
         "max_abs_err": max(k2_err), "ms": k2_main[0], "plain_ms": k2_main[1]},
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
