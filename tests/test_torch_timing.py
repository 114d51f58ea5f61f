"""Port: ``kernels/timing.py`` — the reference's ``tests/test_timing.py``
cases on the port (median estimator, warmup discipline, injectable timer
and sync), and the port's default sync, which waits for the card only when
the result is or holds a CUDA tensor."""
import dataclasses

import pytest
import torch

from repro.kernels import timing as jax_timing
from repro_torch.kernels import timing


@pytest.mark.parametrize("xs", [[3.0, 1.0, 2.0], [4.0, 1.0, 2.0, 3.0],
                                [5.0], [2.0, 2.0, 1.0, 7.0, 0.5, 3.0]])
def test_median_matches_reference(xs):
    # even length: the *upper* median — conservative for one-sided noise
    assert timing.median(xs) == jax_timing.median(xs)


def test_median_odd_and_even():
    assert timing.median([3.0, 1.0, 2.0]) == 2.0
    assert timing.median([4.0, 1.0, 2.0, 3.0]) == 3.0
    assert timing.median([5.0]) == 5.0


def test_median_empty_raises():
    with pytest.raises(ValueError):
        timing.median([])


def test_median_does_not_mutate_input():
    xs = [3.0, 1.0, 2.0]
    timing.median(xs)
    assert xs == [3.0, 1.0, 2.0]


class _Clock:
    """timer() returns scripted instants; one tick per call."""

    def __init__(self, instants):
        self.instants = list(instants)

    def __call__(self):
        return self.instants.pop(0)


def test_measure_returns_median_interval():
    calls = []

    def fn():
        calls.append(1)
        return "result"

    synced = []
    # 3 timed reps -> 6 timer() calls; intervals 1.0, 5.0, 2.0 -> median 2.0
    clock = _Clock([0.0, 1.0, 10.0, 15.0, 20.0, 22.0])
    t = timing.measure(fn, reps=3, warmup=2, timer=clock,
                       sync=synced.append)
    assert t == 2.0
    assert len(calls) == 5              # 2 warmup + 3 timed
    assert synced == ["result"] * 5     # every call synced, warmups too


def test_measure_agrees_with_reference_on_a_scripted_clock():
    instants = [0.0, 1.0, 10.0, 15.0, 20.0, 22.0, 30.0, 30.5]
    kw = dict(reps=4, warmup=1, sync=lambda x: x)
    assert timing.measure(lambda: None, timer=_Clock(instants), **kw) == \
        jax_timing.measure(lambda: None, timer=_Clock(instants), **kw)


def test_measure_warmup_outside_timed_region():
    clock = _Clock([0.0, 3.0])
    t = timing.measure(lambda: None, reps=1, warmup=4, timer=clock,
                       sync=lambda x: x)
    assert t == 3.0
    assert clock.instants == []


def test_measure_passes_args_through():
    seen = []
    clock = _Clock([0.0, 1.0])
    timing.measure(lambda a, b: seen.append((a, b)), "x", 7,
                   reps=1, warmup=0, timer=clock, sync=lambda x: x)
    assert seen == [("x", 7)]


def test_measure_validates_reps_and_warmup():
    with pytest.raises(ValueError):
        timing.measure(lambda: None, reps=0)
    with pytest.raises(ValueError):
        timing.measure(lambda: None, warmup=-1)


def test_measure_default_sync_on_cpu_tensors(monkeypatch):
    """CPU results need no wait: the default sync never touches CUDA."""
    def boom(*a, **k):
        raise AssertionError("CPU results must not synchronize the card")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    t = timing.measure(lambda: torch.arange(4) + 1, reps=1, warmup=1)
    assert t >= 0.0


@dataclasses.dataclass
class _Holder:
    x: object
    label: str = "r"


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on the card, for the holder walk."""

    @property
    def is_cuda(self):
        return True


def test_default_sync_walks_containers(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(1))

    def cuda_like():
        return torch.zeros(1).as_subclass(_CudaLike)

    for held in (cuda_like(), [1, cuda_like()], {"a": (cuda_like(),)},
                 _Holder(cuda_like())):
        assert timing._default_sync(held) is held
    assert len(synced) == 4
    for plain in (None, 3.0, [1, 2], {"a": "b"}, _Holder(torch.zeros(2))):
        timing._default_sync(plain)
    assert len(synced) == 4


def test_stopwatch_is_monotonic():
    sw = timing.stopwatch()
    a = sw.us()
    b = sw.us()
    assert 0.0 <= a <= b
