"""The trace reader on a synthetic timeline: busy time, idle gaps named
by the host's span, copies, and the depthwise sites' forward and backward
device time matched through the autograd sequence numbers."""

from __future__ import annotations

from benchmark.trace import Ev, Trace


def cpu(name, a, b, corr=0, seq=-1, fwd=0, thread=1):
    return Ev(name, a, b, thread, corr, 0, seq, fwd, False)


def dev(name, a, b, linked):
    return Ev(name, a, b, 9, 0, linked, -1, 0, True)


def test_synthetic_timeline():
    events = [
        cpu("bench.window", 0, 1000),
        cpu("bench.step", 0, 400),
        cpu("bench.dw_site", 10, 50),
        cpu("dlv3::depthwise_fwd", 12, 40, corr=1, seq=7),
        cpu("aten::conv", 60, 70, corr=2, seq=8),
        # the backward, on the autograd thread: the site's node, another node
        cpu("DepthwiseBackward", 300, 350, corr=3, seq=7, fwd=1, thread=2),
        cpu("ConvBackward", 360, 380, corr=4, seq=8, fwd=1, thread=2),
        cpu("bench.segment", 500, 900),
        dev("dw_fwd_tile", 100, 150, linked=1),
        dev("conv_fwd", 150, 250, linked=2),
        dev("dw_bwd_tile", 400, 450, linked=3),
        dev("conv_bwd", 450, 500, linked=4),
        dev("Memcpy HtoD (Pageable -> Device)", 600, 700, linked=0),
        dev("bench.step", 0, 500, linked=0),  # an annotation on the device's timeline
    ]
    tr = Trace(events)
    assert tr.window_s == 1000 / 1e9
    assert tr.busy_s == (150 + 100 + 100) / 1e9
    assert tr.site_device_s() == (50 / 1e9, 50 / 1e9)
    assert tr.device_s("Memcpy") == 100 / 1e9
    assert tr.idle_gaps() == [["bench.segment", 300 / 1e9],  # 700..1000
                              ["bench.step", 150 / 1e9],     # 250..400
                              ["bench.step", 100 / 1e9],     # 0..100
                              ["bench.segment", 100 / 1e9]]  # 500..600
    assert [n for n, _ in tr.device_ops()][0] == "conv_fwd"
