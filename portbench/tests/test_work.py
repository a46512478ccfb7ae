"""The yardstick's operation and byte counts against hand counts."""

from portbench.yardstick import peaks, work

CONV = dict(rows=10, neighbors=4, kernel_points=3, cin=5, cout=7,
            supports=20, need_dx=True)


def test_conv_forward_by_hand():
    w = work.conv_work(CONV)
    # influences 10*4*3*12, aggregation 2*10*4*3*5; y @ W 2*10*(3*5)*7
    assert w["other"] == 10 * 4 * 3 * 12 + 2 * 10 * 4 * 3 * 5 == 2640
    assert w["products"] == 2 * 10 * 15 * 7 == 2100
    # x 20*5, points 20*3 + 10*3, indices 10*4, kernel points 3*3,
    # W 3*5*7, out 10*7, 4 bytes each
    assert w["bytes"] == 4 * (100 + 60 + 30 + 40 + 9 + 105 + 70) == 1656


def test_conv_backward_by_hand():
    w = work.conv_work(CONV, backward=True)
    assert w["products"] == 2 * 2100
    # influences and y again, and the dX contributions
    assert w["other"] == 10 * 4 * 3 * 12 + 2 * (2 * 10 * 4 * 3 * 5) == 3840
    # forward inputs + g (10*7) in; dW (3*5*7) and dX (20*5) out
    assert w["bytes"] == 4 * (100 + 60 + 30 + 40 + 9 + 105 + 70 + 105
                              + 100)
    no_dx = work.conv_work(dict(CONV, need_dx=False), backward=True)
    assert no_dx["other"] == 1440 + 1200
    assert no_dx["bytes"] == w["bytes"] - 4 * 100


def test_linear_and_model_flops_by_hand():
    lin = ("linear", dict(rows=8, cin=3, cout=2, need_dx=True))
    assert work.model_flops([lin], training=False) == 2 * 8 * 3 * 2
    assert work.model_flops([lin], training=True) == 3 * 96
    conv = ("conv", CONV)
    assert work.model_flops([conv], training=False) == 1200 + 2100
    assert work.model_flops([conv], training=True) == 1200 + 3 * 2100


def test_bound_takes_the_largest_part():
    w = dict(bytes=peaks.HBM_BYTES_PER_S, products=0.0, other=0.0)
    assert work.bound_s(w) == (1.0, "bytes")
    w = dict(bytes=1.0, products=2 * peaks.TF32_FLOP_PER_S, other=0.0)
    assert work.bound_s(w) == (2.0, "products")
    calls = [("conv", CONV), ("linear", dict(rows=1, cin=1, cout=1,
                                              need_dx=False))]
    assert work.kpconv_bound_s(calls, training=True) == \
        work.bound_s(work.conv_work(CONV))[0] + \
        work.bound_s(work.conv_work(CONV, backward=True))[0]
