"""The roofline arithmetic on known shapes."""

import pytest

from benchmark import roofline


def test_launch_work_counts_the_plain_contraction():
    # five 2-D windows at 2P = 32, n = 1e6, ten right-hand sides
    flops, nbytes = roofline.launch_work("adjoint", 1_000_000, 5, 0, 32, 10)
    assert flops == 2.0 * 1_000_000 * 5 * 32 * 32 * 10
    assert nbytes == 4 * 1_000_000 * 10 + 4 * 1_000_000 * 10 + 4 * 5 * 32 * 32 * 10
    # three pairs and one single at 2P = 34, one weight set
    flops, nbytes = roofline.launch_work("forward", 200_000, 3, 1, 34, 1)
    assert flops == 2.0 * 200_000 * (3 * 34 * 34 + 34)
    assert nbytes == 4 * 200_000 * 7 + 4 * 200_000 + 4 * (3 * 34 * 34 + 34)


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(989e9, 3.35e12) == pytest.approx(1.0)


def test_ndft_least_seconds_reads_the_counters():
    windows = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    launches = {"packed_adjoint": {"nv=10": 2, "nv=1": 3}, "packed_forward": {"nsets=20": 1},
                "packed_forward_wide": {"2P=64 nsets=2": 1}, "unrelated": {"nv=1": 5}}
    want = (2 * roofline.least_seconds(*roofline.launch_work("adjoint", 1000, 5, 0, 32, 10))
            + 3 * roofline.least_seconds(*roofline.launch_work("adjoint", 1000, 5, 0, 32, 1))
            + roofline.least_seconds(*roofline.launch_work("forward", 1000, 5, 0, 32, 20))
            + roofline.least_seconds(*roofline.launch_work("forward", 1000, 5, 0, 64, 2)))
    assert roofline.ndft_least_seconds(launches, 1000, windows, 32) == pytest.approx(want)
    regen = {"packed_adjoint_regen": {"nv=1": 1}}
    fused = [[0, 1, 2], [3, 4], [5, 6], [7, 8], [9]]
    assert roofline.ndft_least_seconds(regen, 1000, fused, 32) == pytest.approx(
        roofline.least_seconds(*roofline.launch_work("adjoint", 1000, 3, 1, 34, 1)))


def test_wide_pair_at_2p_256_counts_the_plain_contraction():
    # one pair, n = 1e5, 2P = 256, one right-hand side or weight set: the
    # plain contraction's 2 n (2P)^2 operations at the bf16 peak (13.2 us),
    # as every other launch, whichever units the wide kernels use
    flops = 2.0 * 100_000 * 256 * 256
    for op in ("adjoint", "forward"):
        assert roofline.launch_work(op, 100_000, 1, 0, 256, 1)[0] == flops
    want = flops / 989e12
    assert want == pytest.approx(1.325e-5, rel=1e-3)
    assert roofline.least_seconds(*roofline.launch_work("adjoint", 100_000, 1, 0, 256, 1)) == pytest.approx(want)
    launches = {"packed_adjoint_wide": {"2P=256 nv=1": 15}, "packed_forward_wide": {"2P=256 nsets=1": 15}}
    assert roofline.ndft_least_seconds(launches, 100_000, [[0, 1]], 256) == pytest.approx(30 * want)


def test_kernel_names_select_the_ndft_kernels():
    names = roofline.ndft_kernel_names()
    kernels = {"void adjoint_tc_kernel<32, 5>(Args)": 2e-3, "void forward_regen_tc_kernel<34>(x)": 1e-3,
               "ampere_sgemm_128x64_nn": 5e-3, "void at::native::vectorized_elementwise_kernel": 1e-3}
    assert roofline.ndft_device_seconds(kernels, names) == pytest.approx(3e-3)
