"""The least-time arithmetic and the step counting."""

import pytest

from gpubench import roofline

PEAK_F, PEAK_B = 989e12, 3.35e12


@pytest.mark.parametrize("n, bound", [(512, "bytes"), (1024, "operations"),
                                      (2048, "operations")])
def test_burn_in_step(n, bound):
    ops, nbytes = 2.0 * n ** 3, 6.0 * n * n
    assert roofline.burn_in_step_s(n) == pytest.approx(
        max(ops / PEAK_F, nbytes / PEAK_B), rel=1e-12)
    assert (ops / PEAK_F > nbytes / PEAK_B) == (bound == "operations")


def test_burn_in_step_values():
    # 512^2: 1.5729e6 bytes / 3.35e12 = 0.46952 us (bytes-bound)
    assert roofline.burn_in_step_s(512) == pytest.approx(4.6952e-7, rel=1e-4)
    # 1024^2: 2.1475e9 operations / 989e12 = 2.1714 us
    assert roofline.burn_in_step_s(1024) == pytest.approx(2.1714e-6, rel=1e-4)
    # 2048^2: 17.3709 us, the PERF.md kernel table's bound for row 1
    assert roofline.burn_in_step_s(2048) == pytest.approx(17.3709e-6,
                                                          rel=1e-4)


@pytest.mark.parametrize("mib, elements", [(128, 33554432),
                                           (256, 67108864)])
def test_stream_pass(mib, elements):
    assert mib * 1024 * 1024 // 4 == elements
    assert roofline.stream_pass_s(elements) == pytest.approx(
        12.0 * elements / PEAK_B, rel=1e-12)


def test_triad_at_256_mib_is_the_kernel_tables_bound():
    # 32768 x 2048 f32: 240.39 us (PERF.md kernel table, row 3)
    assert roofline.stream_pass_s(32768 * 2048) == pytest.approx(240.39e-6,
                                                                 rel=1e-4)


def test_step_rules():
    # the torch component's burn-in: lo 4, levels 256 and 16384
    assert roofline.escalation_steps(4, [256, 16384]) == 49944
    # run_full_validation's: lo 8, levels 512 and 32768
    assert roofline.escalation_steps(8, [512, 32768]) == 99888
    # the mxu probe (32, 512) and the triad probe (16, 64)
    assert roofline.two_point_steps(32, 512) == 1632
    assert roofline.two_point_steps(16, 64) == 240
