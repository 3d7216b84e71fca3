"""Busy time is the union of device-operation intervals (gpubench/devtrace.py)."""

import pytest

from gpubench import devtrace


@pytest.mark.parametrize("intervals, union", [
    ([(0, 2), (1, 3)], 3),                        # overlapping
    ([(0, 10), (2, 3), (4, 9)], 10),              # nested
    ([(0, 1), (2, 3), (5, 6)], 3),                # disjoint
    ([(5, 6), (0, 1), (0.5, 2)], 3),              # unsorted
    ([(0, 1), (1, 2)], 2),                        # touching
    ([], 0),
])
def test_union_length(intervals, union):
    assert devtrace.union_length(intervals) == pytest.approx(union)


def test_union_below_the_wall_where_the_sum_passes_it():
    # kernels launched with programmatic stream serialization start before
    # their predecessor ends: summed they read more busy time than the wall
    # (a graphed coeff2slot: 35.5 ms busy against 33.7 ms), united they cannot
    kernels = [(i * 1.0, i * 1.0 + 1.6) for i in range(20)]
    wall = (0.0, kernels[-1][1])
    assert sum(b - a for a, b in kernels) > wall[1] - wall[0]
    assert devtrace.union_length(kernels) <= wall[1] - wall[0]


def events(device, host=()):
    return ([(n, "device", a, b) for n, a, b in device]
            + [(n, "host", a, b) for n, a, b in host])


def test_reduce_capture_busy_gaps_and_modules():
    dev = [("ntt_col_pass<8>", 10, 30), ("ntt_row_pass<8>", 25, 40),     # overlap 5
           ("mm_ew_kernel<1>", 60, 70), ("Memcpy HtoD (Pageable -> Device)", 90, 95)]
    host = [("gpubench.window", 0, 100), ("boot.coeff2slot", 38, 80),
            ("cudaGraphLaunch", 6, 7), ("cudaMemcpyAsync", 85, 86), ("cudaLaunchKernel", 7, 8)]
    r = devtrace.reduce_capture(events(dev, host), (0, 100))
    assert r["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["module_s"]["ntt"] == pytest.approx(30e-6)
    assert r["union_s"](("ntt", "modmath")) == pytest.approx(40e-6)
    assert r["device_ops"] == {"ntt": 2, "modmath": 1, "copies": 1}
    assert r["dispatches"] == {"graph_launches": 1, "copies": 1, "kernel_launches": 1}
    gaps = dict((round(s * 1e6), name) for name, s in r["idle_gaps"])
    assert gaps[20] == "boot.coeff2slot"        # 40-60, inside the stage's range
    assert gaps[10] == "gpubench.window"        # 0-10, the window alone


def test_events_outside_the_window_are_clipped():
    r = devtrace.reduce_capture(events([("k", -5, 5), ("k", 95, 120)]), (0, 100))
    assert r["busy_s"] == pytest.approx(10e-6)


@pytest.mark.parametrize("seen, complete", [
    ({"ntt": 16, "modmath": 3}, True),     # two kernels a counted NTT launch
    ({"ntt": 15, "modmath": 3}, False),    # one NTT kernel lost
    ({"ntt": 16, "modmath": 2}, False),    # a K5 launch lost
    ({"ntt": 0, "modmath": 3}, False),
])
def test_events_complete(seen, complete):
    ok, table = devtrace.events_complete(seen, {"ntt": 8, "modmath": 3, "limbs": 0})
    assert ok is complete
    assert set(table) == {"ntt", "modmath"}


@pytest.mark.parametrize("name, module", [
    ("void ntt_col_pass<unsigned long, 3>(...)", "ntt"),
    ("ntt4_stage_kernel<8, true>", "ntt4"),
    ("rns_lift_kernel", "rns lift"),
    ("mm_keyprod_kernel", "modmath"),
    ("limbs_add_kernel", "limbs"),
    ("Memset (Device)", "copies"),
    ("ampere_dgemm_64x64", "matmul"),
    ("at::native::vectorized_elementwise_kernel", "other torch"),
])
def test_kernel_module(name, module):
    assert devtrace.kernel_module(name) == module
