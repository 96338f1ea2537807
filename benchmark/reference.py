"""The plain reference: every element of a Sonic proof worked out again
from the trapdoor (x, alpha) and the inputs, in Python integers.

A commitment to f(X) is sum_e f_e g^(alpha x^(e + d - max)), which is
g^(alpha x^(d - max) f(x)); an opening of f at z is f(z) and
g^((f(x) - f(z)) / (x - z)) (Sonic's CommitmentScheme.hs). So each proof
element is one field expression, evaluated at the trapdoor, and at most one
multiple of the generator: no SRS, no multi-scalar multiplication, no
polynomial product or division. Every polynomial of the protocol
(Constraints.hs) is evaluated in closed form at a point:

  r'(X, Y) depends on XY only: rho(w) = sum_i aL_i w^i + aR_i w^-i
      + aO_i w^-(i+n) + sum_{k=1..4} c_k w^-(2n+k); r'(X, 1) = rho(X)
  s(a, b) = sum_q b^(n+1+q) Omega_q(a) - a^n (G(ab) + G(a/b)), with
      Omega_q(a) = sum_i wL[q,i] a^-i + wR[q,i] a^i + wO[q,i] a^(i+n)
      and G(w) = sum_{i=1..n} w^i
  k(y) = sum_q cs_q y^(n+1+q);  t(a, y) = rho(a) (rho(a y) + s(a, y)) - k(y)

The proof's elements, in the order of `names(m)`:

  pr_r = g^(alpha x^(d-n) rho(x))      pr_t = g^(alpha t(x, y))
  pr_a = rho(z), pr_wa = g^((rho(x) - rho(z)) / (x - z))
  pr_b = rho(yz), pr_wb = g^((rho(x) - rho(yz)) / (x - yz))
  pr_wt = g^((t(x, y) - t(z, y)) / (x - z)),  pr_s = s(z, y)
  helper (Signature.hs), for each j: S_j = g^(alpha s(x, y_j)),
  s_j = s(z_j, y_j), W_j = g^((s(x, y_j) - s_j) / (x - z_j)),
  s'_j = s(u, y_j), W'_j = g^((s(x, y_j) - s'_j) / (x - u)),
  Q_j = g^((s(u, x) - s'_j) / (x - y_j)); then Qv = g^((s(u, x) -
  s(u, v)) / (x - v)), C = g^(alpha s(u, x)), u and v.

The module imports numpy and the standard library only: nothing of the
port, of the JAX package or of jax. Proofs are worked out in worker
processes (`expected`), each of which makes the inputs again from the
seed and the configuration, with its circuit family and `gen`. Omega,
s and k sum over the weights' nonzeros and over Q with numpy's object
arrays (gathers, products and `reduceat`), never over a dense Q x n
matrix or a loop in Python over rows.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

from . import g1, gen

P = gen.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # where `benchmark` imports from


def names(m: int) -> list:
    """The names of a proof's 6m + 12 elements, in order."""
    out = ["pr_r", "pr_t", "pr_a", "pr_wa", "pr_b", "pr_wb", "pr_wt", "pr_s"]
    for j in range(m):
        out += [f"S_{j}", f"s_{j}", f"W_{j}"]
    for j in range(m):
        out += [f"s'_{j}", f"W'_{j}", f"Q_{j}"]
    return out + ["Qv", "C", "u", "v"]


def powers(a: int, n: int) -> np.ndarray:
    """[a^1, ..., a^n] mod P as an object array (two short ladders and
    their outer product)."""
    k = max(1, min(256, n))
    lo, p = [], 1
    for _ in range(k):
        p = p * a % P
        lo.append(p)
    hi, p = [], 1
    for _ in range(-(-n // k)):
        hi.append(p)
        p = p * lo[-1] % P
    out = np.multiply.outer(np.array(hi, dtype=object), np.array(lo, dtype=object)) % P
    return out.reshape(-1)[:n]


def geom(w: int, n: int) -> int:
    """sum_{i=1..n} w^i mod P."""
    w %= P
    if w == 1:
        return n % P
    return w * (pow(w, n, P) - 1) * pow(w - 1, -1, P) % P


def over_q(vals, b: int, n: int) -> int:
    """sum_q vals_q b^(n+1+q) mod P, over the Q entries of `vals`."""
    vals = np.asarray(vals, dtype=object)
    return pow(b, n, P) * int(np.dot(vals, powers(b, vals.size)) % P) % P


class Circuit:
    """One circuit's weights as sparse rows (the family's `gen.Rows` of
    wL, wR and wO)."""

    def __init__(self, rows: tuple):
        self.rows = rows
        self.q, self.n = rows[0].q, rows[0].n

    def omega(self, a: int) -> np.ndarray:
        """[Omega_q(a) for each q], an object array."""
        pos, neg = powers(a, self.n), powers(pow(a, -1, P), self.n)
        wl, wr, wo = self.rows
        return (wl.products(neg) + wr.products(pos) + int(pos[-1]) * wo.products(pos)) % P

    def s(self, om: np.ndarray, a: int, b: int) -> int:
        """s(a, b) from Omega(a)."""
        n = self.n
        return (over_q(om, b, n) - pow(a, n, P) * (geom(a * b, n) + geom(a * pow(b, -1, P), n))) % P


class Reference:
    """Works out the proofs of one cell's inputs (the configuration's
    circuit family and `gen`, from the seed)."""

    def __init__(self, seed: int, config: dict):
        self.seed, self.config = seed, config
        self.n, self.d = config["gates"], config["d"]
        self.family = gen.family(config)
        self.x, self.alpha = gen.trapdoor(seed)
        self.fb = g1.FixedBase()
        self._circuits, self._witnesses = {}, {}

    def circuit(self, c: int):
        """(Circuit, Omega(x)) of circuit c."""
        if c not in self._circuits:
            cir = Circuit(self.family.rows(self.seed, c, self.config))
            self._circuits[c] = (cir, cir.omega(self.x))
        return self._circuits[c]

    def witness(self, c: int, k: int):
        """(Witness, aL, aR, aO as object arrays) of circuit c's witness k."""
        if (c, k) not in self._witnesses:
            w = self.family.witness(self.seed, c, k, self.config, self.circuit(c)[0].rows)
            self._witnesses[(c, k)] = (w,) + tuple(np.array(v, dtype=object) for v in (w.aL, w.aR, w.aO))
        return self._witnesses[(c, k)]

    def rho(self, wit, cns: list, w: int) -> int:
        n = self.n
        _, aL, aR, aO = wit
        pos, neg = powers(w, n), powers(pow(w, -1, P), n)
        acc = int(np.dot(aL, pos)) + int(np.dot(aR, neg)) + int(neg[-1]) * int(np.dot(aO, neg))
        wi = pow(w, -1, P)
        for k, ck in enumerate(cns):
            acc += ck * pow(wi, 2 * n + k + 1, P)
        return acc % P

    def proof(self, c: int, k: int, rnd: gen.Rnd) -> list:
        """Proof elements (scalars as ints, points as affine tuples or None)
        for circuit c, witness k and randomness rnd, in `names` order."""
        n, d, x, alpha = self.n, self.d, self.x, self.alpha
        cir, om_x = self.circuit(c)
        wit = self.witness(c, k)
        cs = wit[0].cs
        y, z, u, v = rnd.y, rnd.z, rnd.u, rnd.v

        def rho(w):
            return self.rho(wit, rnd.cns, w % P)

        def g(e):
            return self.fb.mul(e)

        def quot(num, den):
            return num * pow((den) % P, -1, P) % P

        rx, rz, ryz, rxy = rho(x), rho(z), rho(y * z), rho(x * y)
        ky = over_q(cs, y, n)
        om_z = cir.omega(z)
        s_xy, s_zy = cir.s(om_x, x, y), cir.s(om_z, z, y)
        t_x = (rx * (rxy + s_xy) - ky) % P
        t_z = (rz * (ryz + s_zy) - ky) % P
        out = [
            g(alpha * pow(x, d - n, P) * rx), g(alpha * t_x),
            rz, g(quot(rx - rz, x - z)),
            ryz, g(quot(rx - ryz, x - y * z)),
            g(quot(t_x - t_z, x - z)), s_zy,
        ]
        om_u = cir.omega(u)
        s_ux = cir.s(om_u, u, x)
        s_x = [cir.s(om_x, x, yj) for yj in rnd.ys]
        s_u = [cir.s(om_u, u, yj) for yj in rnd.ys]
        for yj, zj, sx in zip(rnd.ys, rnd.zs, s_x):
            sz = cir.s(cir.omega(zj), zj, yj)
            out += [g(alpha * sx), sz, g(quot(sx - sz, x - zj))]
        for yj, sx, su in zip(rnd.ys, s_x, s_u):
            out += [su, g(quot(sx - su, x - u)), g(quot(s_ux - su, x - yj))]
        out += [g(quot(s_ux - cir.s(om_u, u, v), x - v)), g(alpha * s_ux), u % P, v % P]
        return out


_REF = None


def _init(seed: int, config: dict) -> None:
    global _REF
    _REF = Reference(seed, config)


def _job(job) -> list:
    c, k, rnd = job
    return _REF.proof(c, k, rnd)


def expected(seed: int, config: dict, jobs: list, workers: int) -> list:
    """The reference's proof for each (circuit, witness, Rnd) of `jobs`, in
    order, over `workers` worker processes (in this one when 1).

    Each worker is a Python process that runs `_serve`, with its share of the
    jobs pickled on its standard input and its proofs pickled back on its
    standard output. The workers are plain subprocesses, not a
    multiprocessing pool, whose resource tracker would outlive the call:
    every worker has ended, killed if need be, before this returns or
    raises."""
    if workers <= 1 or len(jobs) <= 1:
        _init(seed, config)
        return [_job(j) for j in jobs]
    shares = [list(range(w, len(jobs), workers)) for w in range(min(workers, len(jobs)))]
    procs = []
    try:
        for share in shares:
            p = subprocess.Popen([sys.executable, "-c", _WORKER], cwd=ROOT, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((seed, config, [jobs[i] for i in share])))
            p.stdin.close()
        out = [None] * len(jobs)
        for share, p in zip(shares, procs):
            got = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"a reference worker exited with {p.returncode}")
            for i, proof in zip(share, pickle.loads(got)):
                out[i] = proof
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stdout.close()


_WORKER = f"import sys; sys.path.insert(0, {ROOT!r}); from benchmark import reference; reference._serve()"


def _serve() -> None:
    """A worker of `expected`: its jobs from standard input, its proofs to
    standard output."""
    seed, config, jobs = pickle.load(sys.stdin.buffer)
    _init(seed, config)
    sys.stdout.buffer.write(pickle.dumps([_job(j) for j in jobs]))
    sys.stdout.buffer.flush()
