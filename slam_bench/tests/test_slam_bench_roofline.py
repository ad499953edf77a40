"""The kernels' operation and byte counts against hand counts."""

import torch

from slam_bench import roofline


def test_bound_is_the_larger_of_the_two():
    assert roofline.bound_s(3.35e12, 0) == 1.0
    assert roofline.bound_s(0, 67e12) == 1.0
    assert roofline.bound_s(3.35e9, 67e12) == 1.0


def test_sad_counts():
    # 10 keypoints: (121 + 231) float32 reads, 4 int32 centres, 11 float32 sums
    assert roofline.sad_counts(10) == (10 * (352 * 4 + 16 + 44), 10 * 11 * 121 * 3)


def test_compass_count_by_hand():
    lv = torch.zeros(40, 40)
    lv[20, 20] = 100.0  # a bright dot: its four neighbours at distance 3 see it darker
    # the dot's own ring is all dark (0 < 100 - 7): two neighbouring compass points
    # darker than the centre, and each compass neighbour at distance 3 of the dot
    # has the dot as one compass point only, which is not two
    assert roofline.compass_pass_count([lv], 7.0, border=16) == 1


def test_extraction_counts_by_hand():
    pyr = (torch.zeros(2, 64, 64), torch.zeros(2, 53, 53))
    sizes = ((64, 64), (53, 53))
    c = roofline.extraction_counts(pyr, sizes, n_cells=13, k_max=5, th_low=7.0, n_valid=30)
    px = 64 * 64 + 53 * 53
    scored = (64 - 30) ** 2 + (53 - 30) ** 2
    assert c["fast_candidates"] == (2 * (4 * px + 8 * 13 * 5), 2 * 38 * scored)
    assert c["gaussian_blur7"] == (2 * 8 * px, 2 * 26 * px)
    assert c["brief_sample"] == (30 * (2048 + 48), 30 * (4096 + 256))


def test_roofline_share():
    kernels = {"void fast_candidates_kernel(float const*)": [2e-6, 2e-6],
               "sad_stereo_kernel": [1e-6], "elementwise": [5.0]}
    expected = {"fast_candidates": [(3.35e6, 0), (3.35e6, 0)], "sad_stereo": [(0, 67e6)],
                "gaussian_blur7": [], "brief_sample": []}
    # bounds 1e-6 each: (2e-6 + 1e-6) / (4e-6 + 1e-6)
    assert abs(roofline.roofline_share(kernels, expected) - 60.0) < 1e-9
    assert roofline.roofline_share({}, expected) is None
