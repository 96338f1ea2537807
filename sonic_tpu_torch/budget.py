"""How much device memory one step of a batched computation may take.

The reference bounds its batched MSM by bytes of bucket grid, one module
constant (`sonic_tpu/msm/pippenger.py:462-469`, 3 << 29). The port runs
three batched steps in slices of their batch axis, and bounds all three
by one number of bytes, STEP_BYTES. Each step states what one unit of
its work holds at its peak, temporaries included, and a slice takes as
many units as fit (`per_step`), at least one:

  - `msm/pippenger.py`: a digit slot M N W of a bucket plan, SLOT_BYTES
    (the plan's index code holds ~93 B of int64 temporaries an entry);
  - `constraints.py`: an Fr product of the s(X, y) weighted sums,
    PRODUCT_BYTES (the product, its two expanded operands and the adds of
    its sum, ~12 limb vectors of 128 B);
  - `poly/laurent.py`: a coefficient of a batched division, COEFF_BYTES
    (the helper's 64 x 196,609 at n = 2^16 in one piece raised the
    prove's peak to 37.46 GiB on an NVIDIA H100 80GB HBM3, 700.00 W).

At n = 2^16, q = 64 this cuts the helper's batched MSMs over 3n + 1
points into slices of 15, its s(X, y_j) builds into 2 q at a time and its
batched divisions into slices of 21. Nothing is cut at n <= 1024.
"""
from __future__ import annotations

STEP_BYTES = 12 << 30
SLOT_BYTES = 96
PRODUCT_BYTES = 12 * 128
COEFF_BYTES = 24 * 128


def per_step(unit_bytes: int) -> int:
    """Units of `unit_bytes` one step may take within STEP_BYTES: at least one."""
    return max(1, STEP_BYTES // max(1, unit_bytes))
