"""The rate of answers in a window, read from burst to burst."""
import numpy as np
import pytest

from bench import cell


def bursts(phase, sizes=None):
    """Batches of answers every 0.5 s from ``phase``, each batch's answers
    handed out over 2 ms."""
    out = []
    for k in range(-4, 30):
        n = sizes[k % len(sizes)] if sizes else 64
        out += [phase + 0.5 * k + 2e-3 * i / n for i in range(n)]
    return out


@pytest.mark.parametrize("phase", [0.0, 0.13, 0.31, 0.4995, 0.4999])
def test_batches_read_their_rate_whatever_the_phase(phase):
    """Batches of 64 every 0.5 s: a 10 s window reads 128 a second at every
    phase, also where it opens or closes inside a burst; a count inside the
    window reads 1,216, 1,280 or 1,344, or a part of a batch more."""
    n, span = cell.answered(bursts(phase), 2.0, 12.0)
    assert n % 64 == 0
    assert n / span == pytest.approx(128.0, rel=1e-3)


def test_uneven_batches_count_whole():
    n, span = cell.answered(bursts(0.2, sizes=[64, 40, 64, 13]), 2.0, 12.0)
    assert n == 5 * (64 + 40 + 64 + 13)
    assert span == pytest.approx(10.0, abs=1e-9)


def test_a_steady_stream_reads_its_rate():
    """No pause longer than a burst's gap: the answers in the window over
    its seconds."""
    done = list(np.arange(0.0, 20.0, 0.005))
    n, span = cell.answered(done, 5.0, 15.0)
    assert n / span == pytest.approx(200.0, rel=1e-3)


def test_no_answer_reads_nothing():
    assert cell.answered([], 2.0, 12.0) == (0, 10.0)
