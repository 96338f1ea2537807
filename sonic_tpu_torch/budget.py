"""How much device memory one step of a batched computation may take.

The reference bounds its batched MSM by bytes of bucket grid, one module
constant (`sonic_tpu/msm/pippenger.py:462-469`, 3 << 29), and cuts its
fixed-base multiplication into chunks of 2^16 rows
(`sonic_tpu/msm/fixed_base.py:89-117`). The port runs its batched steps in
slices of their batch axis, and bounds all of them by one number of
bytes, STEP_BYTES. Each step states what one unit of its work holds at
its peak, temporaries included, and a slice takes as many units as fit
(`per_step`), at least one:

  - `msm/pippenger.py`: a digit slot M N W of a bucket plan, SLOT_BYTES
    (the plan's index code holds ~93 B of int64 temporaries an entry),
    cut along M and, where one MSM's N W slots alone exceed the step,
    along N as well: contiguous slices of the points, each with its own
    digits, plan and bucket-sums launch, their sums added in slice order
    (t's commitment at n = 2^20 is 31 GB of slots in one piece);
  - `constraints.py`: an Fr product of the s(X, y) weighted sums, cut
    along q, PRODUCT_BYTES (the product, its two expanded operands and
    the adds of its sum, ~12 limb vectors of 128 B), and a (q, i) term of
    s(u, Y)'s Y^(n+q) coefficients, cut along q too; and, for a circuit
    given as sparse rows, a term of `row_sums` (a power gathered at one
    nonzero for one y or u: the term, its scaled copy and the kernel's
    expanded weight operand), TERM_BYTES, cut along the nonzeros;
  - `poly/laurent.py`: a coefficient of a batched division or of a
    batched product's transform, `poly/ntt.py`: a coefficient of a batch
    of columns or rows of a product's four-step transform, taken above
    the step (half of it, the other half for the transforms' whole
    arrays: t(X, y) at n = 2^20 is a transform of 2^23), and
    `protocol.prove_batch`: a coefficient of the sum r(X, y) + s(X, y)
    that feeds t, COEFF_BYTES
    (the helper's 64 x 196,609 division at n = 2^16 in one piece raised
    the prove's peak to 37.46 GiB; a `limb.add` holds ~10 operand-sized
    temporaries at once);
  - `signature.hsc_prove_device`: a coefficient of one helper instance's
    s(X, y_j), INSTANCE_BYTES, for what the helper of one proof holds
    over a slice of its m instances: the polynomial, an opening's
    quotient and its standard-form scalars (3 x 128 B) and the s(X, y_j)
    build's products at one q (PRODUCT_BYTES for each of the n, a third
    of the coefficients: 512 B);
  - `protocol.prove_batch`: the same over a slice of the proofs,
    HELPER_BYTES: INSTANCE_BYTES and the slice's stacked weights (~200 B
    at q = m = 8);
  - `msm/fixed_base.py`: a row of `fixed_base_mul` in each group,
    BASE_ROW_BYTES (chip_smoke.py phase 12 measures a row over 2^18 rows:
    14,033 B in G1 and 41,637 B in G2; a row's `to_affine`, which
    `SRS.new` runs a chunk at a time too, 1,538 and 11,489 B).

Measured on an NVIDIA H100 80GB HBM3, 700.00 W (`chip_smoke.py`). At
n = 2^16, q = 64 this cuts the helper's batched MSMs over 3n + 1 points
into slices of 15, its s(X, y_j) builds into 2 q at a time and its
batched divisions into slices of 21; a batch of 64 proofs at n = 2^16,
q = 8 runs its helper in 11 slices of the proofs; the SRS tables at
d = 458,772 are built in chunks of 898,779 G1 and 306,900 G2 rows.
Nothing is cut at n <= 1024 or d <= 2^16, and at n <= 2^16 nothing is
cut along N, no helper of one proof and no s(u, Y) build is cut, and no
product takes the four-step split. At n = 2^20, q = 64 (d = 7,340,052) t's commitment and
opening run over 3 slices of their ~7.34 M points, the MSMs over
3n + 1 points over 2, the helper over 16 slices of 4 of its 64
instances, s(u, Y)'s terms 8 q at a time, and t's product (a transform
of 2^23) in 4 batches of columns and 4 of rows: the prove's peak was
55.74 GiB with the circuit and the SRS (`breakdown --check`).
"""
from __future__ import annotations

STEP_BYTES = 12 << 30
SLOT_BYTES = 96
PRODUCT_BYTES = 12 * 128
TERM_BYTES = 4 * 128
COEFF_BYTES = 24 * 128
INSTANCE_BYTES = 7 * 128
HELPER_BYTES = INSTANCE_BYTES + 3 * 128
BASE_ROW_BYTES = {"G1": 14 << 10, "G2": 41 << 10}


def per_step(unit_bytes: int) -> int:
    """Units of `unit_bytes` one step may take within STEP_BYTES: at least one."""
    return max(1, STEP_BYTES // max(1, unit_bytes))
