"""The trace's count of kernels in each chain call, and the check that
holds it against the steps the taps counted."""

from types import SimpleNamespace

from gpubench import compare, trace
from gpubench.taps import Answer


class _Event:
    def __init__(self, start, end, name, cuda=False, corr=0):
        self._e = (start, end, name, cuda, corr)

    def start_ns(self):
        return self._e[0]

    def end_ns(self):
        return self._e[1]

    def name(self):
        return self._e[2]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._e[3] else DeviceType.CPU

    def correlation_id(self):
        return self._e[4]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_kernels_counted_by_launch():
    ev = [_Event(0, 1000, "gpubench.window"),
          # one stress call: three launches inside its mark, run later
          _Event(100, 400, "gpubench.chain.stress"),
          _Event(110, 120, "cudaLaunchKernel", corr=1),
          _Event(130, 140, "cudaGraphLaunch", corr=2),
          _Event(300, 310, "cudaMemcpyAsync", corr=3),
          _Event(150, 160, "add_kernel", cuda=True, corr=1),
          _Event(450, 500, "add_kernel", cuda=True, corr=2),
          _Event(500, 550, "add_kernel", cuda=True, corr=2),
          _Event(550, 560, "Memcpy DtoD (Device -> Device)", cuda=True,
                 corr=3),
          # a second call that launched nothing
          _Event(600, 700, "gpubench.chain.stress"),
          _Event(800, 900, "gpubench.chain.burn_in"),
          _Event(810, 820, "cudaLaunchKernel", corr=4),
          _Event(830, 840, "mm_kernel", cuda=True, corr=4),
          # a host op whose own correlation id collides with a launch's
          _Event(950, 960, "aten::add_", corr=1)]
    t = trace.summarize(_prof(ev))
    assert t.launches == {"stress": [3, 0], "burn_in": [1]}


KINDS = {"stress": SimpleNamespace(CHAIN=True),
         "fma": SimpleNamespace(CHAIN=False)}


def _answers(steps, kind="stress"):
    return [Answer(kind, 8, n, None, float(i), float(i) + 0.5, 0)
            for i, n in enumerate(steps)]


def test_sound_chains_read_nought():
    assert compare.short_chains(_answers([2, 128]), {"stress": [3, 129]},
                                {0}, KINDS) == []


def test_a_short_chain_is_counted():
    assert compare.short_chains(_answers([2, 128]), {"stress": [3, 64]},
                                {0}, KINDS) == [("stress", 128, 64)]


def test_a_call_the_trace_missed_is_counted():
    assert compare.short_chains(_answers([2, 128]), {"stress": [3]},
                                {0}, KINDS) == [("stress", 128, None)]
    assert compare.short_chains(_answers([2]), {"stress": [3, 7]},
                                {0}, KINDS) == [("stress", None, 7)]


def test_untraced_passes_and_other_kinds_are_left_out():
    answers = _answers([2, 128]) + _answers([1], kind="fma")
    answers[1].pass_index = 5
    assert compare.short_chains(answers, {"stress": [2]}, {0}, KINDS) == []


def test_a_name_bound_to_a_tap_is_refused():
    import sys
    import types

    import pytest

    from gpubench.taps import Taps

    module = types.ModuleType("gpubench_tap_probe")
    module.f = lambda x: x
    sys.modules[module.__name__] = module
    try:
        taps = Taps()
        taps.patch("gpubench_tap_probe:f", taps.span("f"))
        module.g = module.f
        with pytest.raises(RuntimeError):
            taps.patch("gpubench_tap_probe:g", taps.span("g"))
        taps.remove()
        assert not getattr(module.f, "gpubench_tap", False)
    finally:
        del sys.modules[module.__name__]
