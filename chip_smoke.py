#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sonic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both CUDA kernels (csrc/ -> sonic_tpu_torch/_build/) and the native
pairing library (native/pairing.cpp), then runs, each phase timed after
torch.cuda.synchronize():

  1. card     the device name, `nvidia-smi` name and power limit, the SM
              clock limit, and the bucket kernel's resident threads;
  2. kernel 1 Montgomery multiply, Fr and Fq, 2^20 random canonical
              elements plus 0, 1 and N-1: equal to mont_mul_plain; timed
              beside its byte bound;
  3. kernel 2 bucket sums (lane-free, sorted by bucket) on random digits
              with infinities, zeros and negative digits at M=2 (also
              against bucket_sums_plain on CPU copies, plain torch
              throughout), and on the 2^16-point MSM's own plan, timed:
              the whole (M, W, B) output equal to bucket_sums_plain; then
              a full 2^16-point MSM equal to the native host Pippenger;
  4. vectors  example1/example2 of tests/vectors/pinned_v1.json: the proof
              bytes equal `proof_hex`, verify True, False after tampering;
  5. main path random_circuit(Random(42), n=1024, q=64), d = 7n+20: SRS.new
              on the card, one warm-up and three timed proofs, verify True
              and False after tampering, pr_r / pr_t equal to native host
              MSMs over the SRS rows, both kernels' launch counts, and the
              phase table of one prove (sonic_tpu_torch.breakdown). Every
              kernel-2 launch of the counted prove (the helper's batched
              ones at M=64 included; the first of them timed) and the first
              kernel-1 launch of each distinct operand shape are kept and
              then held, output for output, against bucket_sums_plain /
              mont_mul_plain on the same inputs; kernel 1 is timed at its
              most-launched shape.

Bounds: kernel 1's from the bytes it must move (each input read once, the
output written once) over 3.35 TB/s; kernel 2's from its plan's mixed
additions (nonzero digits on finite points), 11 Fq products of 2 * 12^2
word products each, a word product being two 32-bit multiply-adds (lo and
hi), over 64 multiply-adds a clock per SM at the SM clock limit.

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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
IMAD_PER_CLOCK_PER_SM = 64  # 32-bit integer multiply-add, compute capability 9.0
IMAD_PER_MIXED_ADD = 11 * 2 * 12 * 12 * 2


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from sonic_tpu_torch import breakdown, golden, kernels, native, protocol, serial
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

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

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
    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fill = kernels.lib().sonic_bucket_sums_fill(0)
    imad_per_ms = IMAD_PER_CLOCK_PER_SM * sms * sm_mhz * 1e3
    log(f"phase 1 card: torch sees {name!r}, {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; {sms} SMs, SM clock limit "
        f"{sm_mhz:.0f} MHz; bucket scan kernel: {fill} resident threads "
        f"({fill / sms / 32:.1f} warps per SM)")
    log(card)

    def k1_bound_ms(a, b, nout):
        return (a.numel() + b.numel() + nout) * 8 / HBM_BYTES_PER_S * 1e3

    def k2_bound_ms(plan):
        return plan.entries * IMAD_PER_MIXED_ADD / imad_per_ms

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
        bound = k1_bound_ms(a, b, got.numel())
        k1[spec.name] = (err, ms, plain_ms, bound)
        log(f"phase 2 kernel 1 {spec.name}: {n + 3} products equal to mont_mul_plain "
            f"(max abs err {err}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"byte bound {bound:.4f} ms ({100 * bound / ms:.1f} % of it)")

    # -- phase 3: kernel 2 ---------------------------------------------------------------
    N = 1 << 16
    base = g1.from_affine(g1.generator(dev))
    (aff, t_pts) = timed(lambda: g1.to_affine(g1.scalar_mul(base, rand_canonical(FR, N))))
    inf = torch.zeros(N, dtype=torch.bool, device=dev)
    inf[::37] = True
    points = Affine(aff.x, aff.y, inf)
    log(f"phase 3 kernel 2: {N} G1 points made on the card in {t_pts:.1f} s")

    def check_sums(pts, plan, label, time_it=True):
        got = bucket_acc.bucket_sums(pts, plan)
        want = bucket_acc.bucket_sums_plain(pts, plan)
        sync()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"kernel 2 {label}: bucket sums differ from bucket_sums_plain")
        what = (f"E={plan.entries} chunks={plan.chunks} steps={plan.steps} "
                f"partials={plan.npartials}; sums {tuple(got.x.shape)} equal to bucket_sums_plain "
                f"(max abs err {err})")
        if not time_it:
            log(f"  kernel 2 {label}: {what}")
            return err, None, None, None
        ms = event_ms(lambda: bucket_acc.bucket_sums(pts, plan), 5)
        plain_ms = event_ms(lambda: bucket_acc.bucket_sums_plain(pts, plan), 1)
        bound = k2_bound_ms(plan)
        log(f"  kernel 2 {label}: {what}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"multiply-add bound {bound:.3f} ms ({100 * bound / ms:.1f} % of it)")
        return err, ms, plain_ms, bound

    M, Nr, c = 2, 1024, 8
    W, nb = 256 // c + 1, (1 << (c - 1)) + 1
    small = Affine(points.x[:Nr], points.y[:Nr], points.inf[:Nr])
    digits = torch.randint(-(nb - 1), nb, (M, Nr, W), generator=gen, device=dev)
    digits[:, ::5] = 0
    plan = bucket_acc.make_plan(small.inf, digits, nb)
    k2_err = [check_sums(small, plan, f"random digits M={M} N={Nr} c={c}")[0]]
    # on the CPU, bucket_sums_plain's products are mont_mul_plain's, so this
    # oracle involves no kernel at all
    cpu = bucket_acc.bucket_sums_plain(Affine(*(a.cpu() for a in small)), plan.to("cpu"))
    got = bucket_acc.bucket_sums(small, plan)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, cpu)):
        raise AssertionError("kernel 2: bucket sums differ from bucket_sums_plain on the CPU")
    log(f"  kernel 2 random digits M={M} N={Nr} c={c}: equal to bucket_sums_plain on CPU copies")

    scalars = rand_canonical(FR, N)
    msm_digits, c_msm, nb_msm = pippenger._lay_out(scalars, None)
    t_plan = event_ms(lambda: bucket_acc.make_plan(points.inf, msm_digits, nb_msm), 3)
    plan16 = bucket_acc.make_plan(points.inf, msm_digits, nb_msm)
    log(f"  kernel 2 2^16-point MSM plan (c={c_msm}): {t_plan:.3f} ms")
    err, k2_16_ms, k2_16_plain, k2_16_bound = check_sums(points, plan16, f"2^16-point MSM c={c_msm}")
    k2_err.append(err)

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
    _, t_msm2 = timed(lambda: g1.to_affine(pippenger.msm(points, scalars)))
    log(f"phase 3 msm: 2^16 points equal to native g1_msm_native; card {t_msm:.3f} s "
        f"(first call), {t_msm2:.3f} s (second); host native {t_native:.3f} s")

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

    # Keep the inputs of every kernel-2 launch and of the first kernel-1
    # launch of each operand shape, to hold them against the plain versions
    # below; count kernel-1 launches by shape.
    sums_kept, products, shape_count = [], {}, {}
    real_sums, real_mul = pippenger.bucket_sums, mont_mul.mont_mul

    def sums_keep(pts, plan):
        sums_kept.append((pts, plan))
        return real_sums(pts, plan)

    def mul_keep(a, b, spec):
        key = (spec.name, tuple(a.shape), tuple(b.shape))
        products.setdefault(key, (a, b, spec))
        shape_count[key] = shape_count.get(key, 0) + 1
        return real_mul(a, b, spec)

    pippenger.bucket_sums, mont_mul.mont_mul = sums_keep, mul_keep
    mont_mul.launches = 0
    bucket_acc.launches = 0
    try:
        (proof, oracle), t_warm = timed(lambda: protocol.prove(srs, da, dc, rnd))
        ok, t_verify = timed(lambda: protocol.verify(srs, dc, proof, oracle.y, oracle.z, oracle.yzs))
    finally:
        pippenger.bucket_sums, mont_mul.mont_mul = real_sums, real_mul
    launches = {"mont_mul": mont_mul.launches, "bucket_sums": bucket_acc.launches}
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

    with breakdown.phase_timers(dev) as acc:
        (proof3, _), t_phases = timed(lambda: protocol.prove(srs, da, dc, rnd))
    if serial.proof_to_bytes(proof3) != serial.proof_to_bytes(proof):
        raise AssertionError("main path: the proof under phase timers differs")
    log(f"phase 5 phase breakdown of one prove (sonic_tpu_torch.breakdown timers), {t_phases:.3f} s:")
    for line in breakdown.phase_table(acc):
        log(line)

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
    top = max(shape_count, key=shape_count.get)
    a, b, spec = products[top]
    nout = torch.broadcast_shapes(a.shape, b.shape).numel()
    top_ms = event_ms(lambda: mont_mul.mont_mul(a, b, spec), 200)
    top_plain = event_ms(lambda: mont_mul.mont_mul_plain(a, b, spec), 20)
    top_bound = k1_bound_ms(a, b, nout)
    log(f"phase 5 kernel 1 most-launched shape {spec.name} {tuple(a.shape)} x {tuple(b.shape)} "
        f"({shape_count[top]} of {sum(shape_count.values())} launches): kernel {top_ms:.4f} ms, "
        f"plain {top_plain:.3f} ms, byte bound {top_bound:.5f} ms")

    log(f"phase 5 kernel 2: the {len(sums_kept)} bucket-sums launches of the counted run:")
    k2_main = None
    largest = max(p.entries for _, p in sums_kept)
    for i, (pts, plan) in enumerate(sums_kept):
        label = f"launch {i} {plan.shape} (M, W, B) over N={plan.npoints}"
        # time the first launch of the largest plan: the helper's batched one
        time_it = k2_main is None and plan.entries == largest
        err, ms, plain_ms, bound = check_sums(pts, plan, label, time_it)
        k2_err.append(err)
        if time_it:
            k2_main = (ms, plain_ms, bound)

    kernels_line = {"kernels": [
        {"name": "mont_mul", "route": "cuda", "source": "sonic_tpu_torch/csrc/mont_mul.cu",
         "replaces": "sonic_tpu/fields/pallas_mul.py:147", "launches": launches["mont_mul"],
         "max_abs_err": max(k1_err), "ms": k1["Fq"][1], "plain_ms": k1["Fq"][2],
         "bound_ms": k1["Fq"][3], "bound_by": "bytes", "library_ms": None},
        {"name": "bucket_sums", "route": "cuda", "source": "sonic_tpu_torch/csrc/bucket_acc.cu",
         "replaces": "sonic_tpu/msm/pallas_acc.py:136", "launches": launches["bucket_sums"],
         "max_abs_err": max(k2_err), "ms": k2_main[0], "plain_ms": k2_main[1],
         "bound_ms": k2_main[2], "bound_by": "operations", "library_ms": None},
    ]}
    log(f"card: {card}; kernel 1 Fr 2^20+3: {k1['Fr'][1]:.4f} ms (bound {k1['Fr'][3]:.4f}); "
        f"kernel 2 2^16-point MSM: {k2_16_ms:.3f} ms (bound {k2_16_bound:.3f}, plain {k2_16_plain:.3f})")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
