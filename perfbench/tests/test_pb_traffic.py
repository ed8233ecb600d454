"""The one generator of traffic."""
import numpy as np

from bench import traffic


def test_closed_loop_has_no_schedule():
    assert traffic.arrivals({"kind": "closed"}, 10, 1) is None


def test_poisson_sends_the_same_count_on_every_seed():
    mix = {"kind": "poisson", "rate_per_s": 750.0}
    a = traffic.arrivals(mix, 50, 4100000001)
    b = traffic.arrivals(mix, 50, 2 ** 31 + 12345)
    assert len(a) == len(b) == 37500
    assert not np.array_equal(a, b)
    for t in (a, b):
        assert np.all(np.diff(t) >= 0) and t[0] >= 0 and t[-1] < 50
    np.testing.assert_array_equal(a, traffic.arrivals(mix, 50, 4100000001))


def test_bursts_fall_in_the_on_periods_at_the_same_mean_rate():
    mix = {"kind": "poisson", "rate_per_s": 100.0,
           "burst": {"on_s": 0.5, "off_s": 1.5}}
    t = traffic.arrivals(mix, 20, 7)
    assert len(t) == 2000
    assert np.all(t % 2.0 < 0.5) and t[-1] < 20
