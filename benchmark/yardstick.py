"""The fixed yardstick of the kernels' rooflines: the card's published
peaks and the work each kernel's inputs need, whatever kernel computes it.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's H100 data sheet: 3.35 TB/s
of HBM3, 132 SMs, a boost clock of 1980 MHz) and the throughput of 32-bit
integer multiply-add (IMAD) on compute capability 9.0: 64 results a clock
an SM (CUDA C++ Programming Guide, "Arithmetic Instructions"). The peaks
assume the card's full power limit of 700 W; the result line records the
card's limit beside them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 1.98e9
IMAD_PER_CLOCK_PER_SM = 64
IMAD_PER_S = IMAD_PER_CLOCK_PER_SM * SMS * SM_CLOCK_HZ

# kernel 2 (bucket accumulation): one complete mixed addition on G1 is 11
# Fq multiplications (7M + 4S); an Fq multiplication over 12 32-bit words
# is a 12 x 12 product and a 12 x 12 Montgomery reduction, each word
# product an IMAD for its low and one for its high half
FQ_MULS_PER_MIXED_ADD = 11
IMAD_PER_FQ_MUL = 2 * 12 * 12 * 2
IMAD_PER_MIXED_ADD = FQ_MULS_PER_MIXED_ADD * IMAD_PER_FQ_MUL  # 6,336
KERNEL_2 = ("bucket_scan_kernel", "bucket_merge_kernel")

# kernel 1 (Montgomery multiply): its operands and results move as int64
# limb tensors, 8 bytes a limb (16 limbs an Fr element, 24 an Fq element)
LIMB_BYTES = 8
KERNEL_1 = ("mont_mul_kernel",)


def plan_entries(args, kwargs, plan) -> int:
    """E, the mixed additions a bucket plan asks for (its entries)."""
    return plan.entries


def launch_bytes(args, kwargs, out) -> int:
    """Bytes of a kernel-1 launch's two operands and its result, each
    counted once (a broadcast operand at its own size)."""
    a, b = args[0], args[1]
    return (a.numel() + b.numel() + out.numel()) * LIMB_BYTES


def share(bound_s: float, kernel_s: float) -> float | None:
    """The least time the work needs over the kernel's device time, in %."""
    if not kernel_s:
        return None
    return 100.0 * bound_s / kernel_s


def bucket_acc_roofline(run, key) -> float | None:
    if run.profile is None or key not in run.hooks:
        return None
    bound = run.hooks[key] * IMAD_PER_MIXED_ADD / IMAD_PER_S
    return share(bound, run.profile.kernel_seconds(KERNEL_2))


def mont_mul_roofline(run, key) -> float | None:
    if run.profile is None or key not in run.hooks:
        return None
    return share(run.hooks[key] / HBM_BYTES_PER_S, run.profile.kernel_seconds(KERNEL_1))


def idle_share(run) -> float | None:
    if not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
