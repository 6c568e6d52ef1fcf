"""The yardstick's arithmetic on hand-worked shapes: the work a launch
needs, the trace's intervals and the readers built on them."""

import math
import types

import pytest
import torch

from benchmark import devtrace, readers, roofline


def test_reduce_lanes_cost_by_hand():
    # 3 lanes of 1 word, profiles of 5 rows; lane 2 runs no column.
    a = dict(peq=torch.zeros((2, 5, 1), dtype=torch.int32),
             targets=torch.zeros((3, 100), dtype=torch.int32),
             hi=torch.tensor([50, 100, 0], dtype=torch.int32),
             prow=torch.tensor([0, 1, 1], dtype=torch.int32),
             trow=torch.tensor([0, 2, 1], dtype=torch.int32))
    nbytes, ops = roofline.reduce_lanes_cost(a)
    assert ops == 150 * (13 + 6)                 # 50 + 100 lane-columns
    # 2 profiles of 5 words, 150 target columns, 3 x 4 lane vectors, 3 x 4
    # outputs, 4 bytes each.
    assert nbytes == 4 * (2 * 5 + 150 + 12 + 12)


def test_sweep_shared_cost_by_hand():
    a = dict(peq_t=torch.zeros((5, 2, 10), dtype=torch.int32),
             target=torch.zeros(1000, dtype=torch.int32), col_hi=900)
    nbytes, ops = roofline.sweep_shared_cost(a)
    assert ops == 10 * 900 * (2 * 13 + 4)
    assert nbytes == 100 * 4 + 900 * 4 + 10 * 8


@pytest.mark.parametrize("q,t,d,width", [(1000, 1000, 100, 101),
                                         (1000, 900, 150, 151),
                                         (900, 1000, 101, 103),
                                         (1000, 1000, 0, 1)])
def test_band_cost_by_hand(q, t, d, width):
    nbytes, ops = roofline.band_cost(q, t, d)
    assert ops == pytest.approx(width * q / 32 * 13)
    assert nbytes == t * 4 + 5 * math.ceil(q / 32) * 4


def test_bound_and_share():
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    ops = roofline.INT32_OPS_PER_S          # one second of operations
    assert roofline.bound_s(1.0, ops) == pytest.approx(1.0)
    assert roofline.bound_s(roofline.HBM_BYTES_PER_S * 2, ops) == \
        pytest.approx(2.0)
    assert roofline.share(0.5, 2.0) == pytest.approx(25.0)
    assert roofline.share(0.5, 0.0) is None      # never 0 for no kernel


def test_recorder_binds_operands():
    def k1(peq, targets, hin0, *, core=None):
        return peq + targets + hin0
    mod = types.SimpleNamespace(k1=k1, KERNELS=(k1,))
    rec = roofline.Recorder(mod)
    assert mod.k1(1, 2, 3) == 6
    rec.on = True
    mod.k1(1, targets=2, hin0=0)
    rec.on = False
    mod.k1(5, 5, 5)
    assert rec.calls["k1"] == [{"peq": 1, "targets": 2, "hin0": 0}]
    rec.restore()
    assert mod.k1 is k1


def _trace():
    # Window 0-10 s: two calls (0-4, 5-10), kernels 1-2, 1.5-3, 6-7 and a
    # copy 9-9.5; host ops under the gaps.
    return devtrace.Trace(
        device=[("void k_a<1>(int)", 1.0, 2.0), ("void k_b(int)", 1.5, 3.0),
                ("void k_a<1>(int)", 6.0, 7.0), ("Memcpy HtoD", 9.0, 9.5)],
        spans=[("call", 0.0, 4.0), ("between_calls", 4.0, 5.0),
               ("call", 5.0, 10.0)],
        host=[("aten::nonzero", 3.2, 3.9), ("aten::copy_", 7.0, 9.0)])


def test_short_names():
    assert devtrace.short("void (anonymous namespace)::sweep_shared_split_"
                          "kernel<5>(unsigned int const*, int)") == \
        "sweep_shared_split_kernel"
    assert devtrace.short("at::native::mbtopk::gatherTopK<float, unsigned "
                          "int, 2>(x)") == "at::native::mbtopk::gatherTopK"
    assert devtrace.short("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD "


def test_intervals_and_breakdown():
    tr = _trace()
    assert devtrace.window(tr) == (0.0, 10.0)
    assert devtrace.merged(tr.device, 0, 10) == [(1.0, 3.0), (6.0, 7.0),
                                                  (9.0, 9.5)]
    assert devtrace.covered(tr.device, 2.5, 6.5) == pytest.approx(1.0)
    bd = devtrace.breakdown(tr, top=3)
    assert bd["device_ops"][0] == ["k_a", 2.0]
    assert [g[1] for g in bd["idle_gaps"]] == [3.0, 2.0, 1.0]
    assert bd["idle_gaps"][0][0] == ("between_calls: python after "
                                     "aten::nonzero before aten::copy_")
    assert bd["idle_gaps"][1][0] == "call: aten::copy_"
    assert bd["idle_gaps"][2][0] == "call: python after - before " \
        "aten::nonzero"
    ctx = types.SimpleNamespace(trace=tr)
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 3.5 / 10))
    # Host ms: call 1 is 4 s with 2 s busy, call 2 5 s with 1.5 s busy.
    assert readers.host_ms(ctx) == pytest.approx(1e3 * (2.0 + 3.5) / 2)
