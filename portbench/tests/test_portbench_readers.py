"""The readers of the program's own spans and counters
(``portbench/program.py`` and the metrics on it), on synthetic traces."""
import importlib.util
import os

import pytest

from portbench.trace import SPAN_PREFIX, Trace

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")
NEW = ("captures", "capture_ms", "host_syncs", "register_prep_ms",
       "register_lm_ms", "idle_capture_ms")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def totals(k):
    """The process's totals after panorama k: every panorama adds the
    same work, so each reader's value a panorama is known."""
    def span(count, total_ms, self_ms):
        return {"count": k * count, "total_ns": int(k * total_ms * 1e6),
                "self_ns": int(k * self_ms * 1e6)}
    return {"spans": {"register.schedule": span(1, 2.0, 2.0),
                      "register.rotations": span(1, 5.0, 5.0),
                      "register.lm": span(1, 150.0, 140.0),
                      "register.polish": span(1, 12.0, 10.0),
                      "graphs.capture": span(3, 12.0, 12.0)},
            "counters": {"graphs.captures": 3 * k, "graphs.replays": 90 * k,
                         "host_syncs": 100 * k + 7},
            "launches": {"gauss_octave": 24 * k}}


def trace(stats, host_spans=(), device=(), window=(0.0, 1.0), n=0):
    return Trace({}, list(stats), list(device), list(host_spans), window, n,
                 {}, {})


def test_totals_difference_per_panorama():
    """(last totals - first totals) / (panoramas - 1), whatever the
    process did before the window (the first totals' offset)."""
    stats = [{"totals": totals(k + 4)} for k in range(6)]
    t = trace(stats)
    got = {name: reader(name)(t) for name in NEW[:5]}
    assert got == pytest.approx({"captures": 3.0, "capture_ms": 12.0,
                                 "host_syncs": 100.0,
                                 "register_prep_ms": 7.0,
                                 "register_lm_ms": 150.0})


def test_nothing_recorded_reads_none():
    """A program without the recorder (no ``totals``, no ``spans``), a
    single panorama, or a counter it never had: every reader is None."""
    bare = trace([{"lm_iterations": [3]}] * 4, [
        (SPAN_PREFIX + "register", 10.0, 20.0)], [("k", 0.0, 5.0)],
        (0.0, 100.0), 1)
    one = trace([{"totals": totals(1)}])
    for name in NEW:
        assert reader(name)(bare) is None, name
        assert reader(name)(one) is None, name
    other = totals(2)
    del other["counters"]["host_syncs"], other["spans"]["register.lm"]
    t = trace([{"totals": totals(1)}, {"totals": other}])
    assert reader("host_syncs")(t) is None
    assert reader("register_lm_ms")(t) is None
    assert reader("captures")(t) == 3.0


def test_idle_capture_aligns_on_the_register_span():
    """The program's spans are Unix ns, the profiler's us from its start:
    each panorama's ``graphs.capture`` spans are shifted by its
    ``register`` span against the benchmark's ``portbench.register``
    span, then intersected with the device's idle gaps."""
    unix = 1_792_000_000_000_000_000          # the program's clock, ns

    def pano(start_us):
        """A profiled panorama whose register span starts at
        ``start_us`` on the profiler's clock: two captures, 1 ms and 2
        ms long, 3 ms and 10 ms after it."""
        r0 = unix + int(start_us * 1e3) + 7 * 10 ** 6
        spans = [("match", None, r0 - 5_000_000, r0 - 1_000_000),
                 ("graphs.capture", "register.lm", r0 + 3_000_000,
                  r0 + 4_000_000),
                 ("graphs.capture", "register.polish", r0 + 10_000_000,
                  r0 + 12_000_000),
                 ("register", None, r0, r0 + 20_000_000)]
        return {"spans": spans, "totals": totals(1)}
    # the benchmark's spans start 5 us before the program's register span;
    # on the profiler's clock the register spans start at 1000 and 31000 us
    hosts = [(SPAN_PREFIX + "register", 995.0, 21_100.0),
             (SPAN_PREFIX + "register", 30_995.0, 51_100.0)]
    # device work: busy over the first capture's first half in panorama 0,
    # over none of panorama 1's captures
    device = [("k0", 0.0, 4_500.0), ("k1", 11_500.0, 12_000.0),
              ("k2", 40_000.0, 40_500.0)]
    stats = [pano(1000.0 - 7000.0), pano(31_000.0 - 7000.0),
             {"totals": totals(3)}]
    t = trace(stats, hosts, device, (0.0, 60_000.0), 2)
    # panorama 0: capture 4000-5000 us (idle 4500-5000: 0.5 ms), capture
    # 11000-13000 (busy 11500-12000: idle 1.5 ms); panorama 1: 3 ms idle;
    # each 5 us late at most
    got = reader("idle_capture_ms")(t)
    assert got == pytest.approx((0.5 + 1.5 + 3.0) / 2, abs=0.01)
    assert reader("idle_capture_ms")(t._replace(host_spans=hosts[:1])) \
        is None
    assert reader("idle_capture_ms")(t._replace(device=[])) is None
