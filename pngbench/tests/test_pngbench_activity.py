"""The arithmetic over the card's activity records, on made-up records."""

import pytest

from pngbench import activity as A


def test_union_and_total():
    assert A.union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    assert A.total([(0, 10), (2, 3), (20, 25)]) == 15
    assert A.total([]) == 0


def test_per_call_splits_at_marks():
    iv = [(0, 5), (12, 18), (19, 30), (31, 33)]
    # calls start at 10, 20, 30; activity before the first is the first's
    assert A.per_call(iv, [10, 20, 30]) == [12, 10, 2]
    assert A.per_call([(25, 45)], [10, 20, 30]) == [0, 5, 15]


def test_gaps():
    assert A.gaps([(2, 4), (6, 8)], 0, 10) == [(0, 2), (4, 6), (8, 10)]
    assert A.gaps([(0, 10)], 0, 10) == []


def test_idle_by_innermost_range():
    ranges = [(0, 100, "A"), (10, 40, "B"), (50, 60, "C")]
    got = A.idle_by_range([(5, 15), (35, 55), (90, 120)], ranges)
    assert got == {"A": 25, "B": 10, "C": 5, "host_outside_any_range": 20}
    assert A.idle_by_range([], ranges) == {}


def test_summarize():
    card = [(9, 10, "kernel", "at::cuda::spin_kernel(long)"),
            (10, 11, "kernel", "at::cuda::spin_kernel(long)"),
            (12, 15, "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)"),
            (14, 18, "kernel", "walk8_kernel"),
            (18, 20, "gpu_memcpy", "Memcpy DtoH (Device -> Pinned)"),
            (30, 31, "kernel", "at::cuda::spin_kernel(long)"),
            (32, 36, "kernel", "walk8_kernel")]
    host = [(9, 21, "harness.decode"), (29, 37, "harness.decode"),
            (21, 29, "decoder.parse")]
    s = A.summarize(card, host)
    assert s["busy"] == 8 + 4 and s["copy"] == 3 + 2
    assert s["stage"] == 4 + 4
    assert s["calls"] == [8, 4]
    assert dict(s["device_ops"]) == {"walk8_kernel": 8,
                                     "Memcpy HtoD (Pinned -> Device)": 3,
                                     "Memcpy DtoH (Device -> Pinned)": 2}
    # idle [9, 12) and [20, 32): 3, 1 and 3 inside calls, 8 in the parse
    assert dict(s["idle_gaps"]) == {"harness.decode": 3 + 1 + 3,
                                    "decoder.parse": 8}


def test_a_lost_marker_loses_no_call_start():
    m = "at::cuda::spin_kernel(long)"
    card = [(0, 1, "kernel", m), (1, 2, "kernel", m), (3, 9, "kernel", "w"),
            (10, 11, "kernel", m), (12, 15, "kernel", "w"),
            (20, 21, "kernel", m), (21, 22, "kernel", m),
            (23, 24, "kernel", "w")]
    assert A.call_starts(card) == [0, 10, 20]
    assert A.summarize(card)["calls"] == [6, 3, 1]


class _Ev:
    def __init__(self, name, ann=False):
        self._n, self._a = name, ann

    def name(self):
        return self._n

    def is_user_annotation(self):
        return self._a


def test_kind_of_without_activity_type():
    assert A.kind_of(_Ev("Memcpy DtoH (Device -> Pinned)"), True) == \
        "gpu_memcpy"
    assert A.kind_of(_Ev("Memset (Device)"), True) == "gpu_memset"
    assert A.kind_of(_Ev("walk8_kernel"), True) == "kernel"
    assert A.kind_of(_Ev("harness.decode"), True) == "gpu_user_annotation"
    assert A.kind_of(_Ev("x", ann=True), True) == "gpu_user_annotation"
    assert A.kind_of(_Ev("aten::copy_"), False) == "cpu_op"


def test_a_run_whose_records_miss_a_call_start_fails():
    """A call start lost with both its markers would merge two calls and
    skew the tail: the run fails instead."""
    from types import SimpleNamespace

    from pngbench import run

    drv = SimpleNamespace(mpix_call=2.0)
    res = {"activity": {"busy": 8e6, "calls": [5e6, 3e6]},
           "calls": [0, 1, 2], "peak_bytes": 10**9}
    with pytest.raises(RuntimeError):
        run.end_to_end(drv, res, 1.5)
    res["calls"] = [0, 1]
    got = run.end_to_end(drv, res, 1.5)
    assert got["card_ms_per_mpix"] == 2.0 and got["peak_device_gb"] == 1.0
