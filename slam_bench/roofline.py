"""Operations and bytes of the port's hand-written kernels K1-K4 at the shapes
a cell launched them with, and the published peaks they are held to.

The counts are a frozen copy of ``chip_smoke.py``'s
(``check_extraction_batch``, ``check_batch_kernels``,
``compass_pass_count``), counted from the dispatch's own images by this
benchmark's reference front end, with the keypoint counts the inputs need
(the valid ones) in place of every slot.  Peaks: NVIDIA's H100 SXM data
sheet, memory 3.35 TB/s and float32 outside the tensor cores 67 TFLOP/s
(every kernel here is float32 or integer arithmetic), at the full 700 W; a
run prints the card's power limit beside them.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
BORDER = 16

# the CUDA function of each kernel, as the device trace names it
KERNEL_NAMES = {
    "fast_candidates": "fast_candidates_kernel",
    "gaussian_blur7": "gaussian_blur7_kernel",
    "brief_sample": "brief_sample_kernel",
    "sad_stereo": "sad_stereo_kernel",
}


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)


def compass_pass_count(levels, th_low: float, border: int = BORDER) -> int:
    """Pixels of the scored area of these (h, w) levels whose FAST score
    can exceed ``th_low``: two neighbouring compass points of the ring both
    brighter, or both darker, than the centre by more than ``th_low``.  K1
    takes the full score of these alone."""
    import torch

    n = 0
    for lv in levels:
        h, w = lv.shape
        d = [torch.roll(lv, (-dy, -dx), (0, 1)) - lv for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
        ok = torch.zeros_like(lv, dtype=torch.bool)
        for side in ([x > th_low for x in d], [x < -th_low for x in d]):
            for a in range(4):
                ok |= side[a] & side[(a + 1) % 4]
        n += int(ok[border - 1:h - border + 1, border - 1:w - border + 1].sum())
    return n


def extraction_counts(pyr: tuple, sizes: tuple, n_cells: int, k_max: int, th_low: float,
                      n_valid: int) -> dict:
    """{kernel: (bytes, operations)} of one launch of K1, K2 and K3 over an
    atlas batch: ``pyr`` the (B, h, w) levels, ``n_valid`` the keypoints
    described over the batch."""
    B = pyr[0].shape[0]
    px = sum(h * w for h, w in sizes)
    scored = sum((h - 2 * BORDER + 2) * (w - 2 * BORDER + 2) for h, w in sizes)
    n_full = sum(compass_pass_count([lv[b] for lv in pyr], th_low) for b in range(B))
    return {
        "fast_candidates": (B * (4 * px + 8 * n_cells * k_max),
                            B * (27 + 11) * scored + (12 + 128 + 31) * n_full),
        "gaussian_blur7": (B * 8 * px, B * 26 * px),
        "brief_sample": (n_valid * (512 * 4 + 16 + 32), n_valid * (512 * 8 + 256)),
    }


def sad_counts(n_keypoints: int) -> tuple:
    """(bytes, operations) of one K4 launch over ``n_keypoints`` left
    keypoints: an 11x11 patch and an 11x21 strip read, 11 sums written."""
    return (n_keypoints * ((121 + 231) * 4 + 4 * 4 + 11 * 4), n_keypoints * 11 * 121 * 3)


def roofline_share(trace_kernels: dict, expected: dict) -> float | None:
    """Summed least time over summed device time of the K1-K4 launches in a
    traced window, in %.  ``expected``: {kernel: [(bytes, ops) per launch]}
    in launch order; ``trace_kernels``: {device op name: [seconds]}.  Where
    the profiler kept fewer records of a kernel than it was launched, the
    launches it kept are taken at that kernel's mean least time."""
    bound = dev = 0.0
    for k, per_launch in expected.items():
        recs = [s for name, v in trace_kernels.items() if KERNEL_NAMES[k] in name for s in v]
        if not recs or not per_launch:
            continue
        mean_bound = sum(bound_s(b, o) for b, o in per_launch) / len(per_launch)
        bound += mean_bound * min(len(recs), len(per_launch))
        dev += sum(recs[:len(per_launch)])
    return 100.0 * bound / dev if dev > 0 else None
