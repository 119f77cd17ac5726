"""The port's recorder (``profiling``): spans, counters, the stages'
``stats``, annotation of the profiler's trace, and the host syncs
counted where they happen (no jax in this file).

The ``gpu`` test holds the ``host_syncs`` counter to PyTorch's
sync-debug mode on the card, stage by stage; it runs on a GPU machine
with ``python -m pytest --noconftest tests/test_torch_profiling.py``.
"""
import json
import logging
import time

import numpy as np
import pytest
import torch

from pano360_tpu_torch import _kernels, cli, graphs, pipeline, profiling
from pano360_tpu_torch import register
from pano360_tpu_torch import render
from pano360_tpu_torch import synth

CPU = torch.device("cpu")
REGISTER_PARTS = ["register.schedule", "register.rotations", "register.lm",
                  "register.polish", "register.readback"]


def _cuda():
    """The card, decided inside the test (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (host syncs against the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world():
    """Four 192x256 views, their matches and rehydrated keypoints on the
    CPU."""
    torch.set_num_threads(4)
    imgs, _, _ = synth.make_views(n_views=4, shape=(192, 256), overlap=0.45,
                                  seed=3)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    stack, feats = pipeline.upload_extract(u8, CPU)
    kpts, matches = pipeline.matching(u8, CPU, feats=feats)
    return dict(u8=u8, stack=stack, feats=feats, kpts=kpts, matches=matches,
                pts=pipeline.idx_to_keypoints(matches, kpts))


def _totals(name):
    return profiling.snapshot()["spans"].get(
        name, {"count": 0, "total_ns": 0, "self_ns": 0})


def test_span_nesting_parents_and_self_time():
    """A span's parent is the span open around it; its self time is its
    total less the time its children cover; the totals add up per name."""
    before = {n: _totals(n) for n in ("t.outer", "t.inner")}
    stats = {}
    with profiling.recording(stats):
        with profiling.span("t.outer") as outer:
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("t.inner"):
                    time.sleep(0.003)
    spans = stats["spans"]
    assert [(n, p) for n, p, _, _ in spans] == [
        ("t.inner", "t.outer"), ("t.inner", "t.outer"), ("t.outer", None)]
    assert all(e >= s for _, _, s, e in spans)
    (_, _, s1, e1), (_, _, s2, e2), (_, _, s0, e0) = spans
    assert s0 <= s1 <= e1 <= s2 <= e2 <= e0
    assert (s0, e0) == (outer.start, outer.end) and outer.parent is None
    inner = {k: _totals("t.inner")[k] - before["t.inner"][k]
             for k in ("count", "total_ns", "self_ns")}
    whole = {k: _totals("t.outer")[k] - before["t.outer"][k]
             for k in ("count", "total_ns", "self_ns")}
    assert inner["count"] == 2 and whole["count"] == 1
    assert inner["total_ns"] == inner["self_ns"] == (e1 - s1) + (e2 - s2)
    assert whole["total_ns"] == e0 - s0
    assert whole["self_ns"] == whole["total_ns"] - inner["total_ns"]
    assert whole["self_ns"] >= 2e6 and inner["total_ns"] >= 6e6


def test_recording_keeps_spans_totals_and_counters():
    """Only the spans closed inside a recording go into its ``stats``;
    ``totals`` is the snapshot as the stage returns, with the counters
    and the kernels' launch counts; ``recording(None)`` keeps nothing."""
    with profiling.span("t.before"):
        pass
    stats = {}
    with profiling.recording(stats):
        with profiling.span("t.a"):
            profiling.count("t.counter", 3)
        profiling.count("t.counter")
    with profiling.recording(None), profiling.span("t.none"):
        pass
    assert [s[0] for s in stats["spans"]] == ["t.a"]
    totals = stats["totals"]
    assert set(totals) == {"spans", "counters", "launches"}
    assert totals["counters"]["t.counter"] >= 4
    assert totals["spans"]["t.a"]["count"] >= 1
    assert "t.none" not in [s[0] for s in stats["spans"]]
    # every kernel entry point by its name, and no other key
    assert set(totals["launches"]) == {
        name[len("p360_"):] for entries in _kernels._SIGNATURES.values()
        for name in entries} == {
        "octave_stack", "backward_warp", "backward_warp_mip", "sift_refine",
        "sift_orient", "sift_orient_block", "sift_descr", "sift_base",
        "sift_small_octave", "ransac_score", "band_blur", "knn2"}
    later = profiling.snapshot()
    assert profiling.delta(later, totals)["counters"]["t.counter"] == 0


def test_a_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with profiling.span("t.raises"):
            raise ValueError("x")
    assert _totals("t.raises")["count"] >= 1
    with profiling.span("t.after") as s:
        pass
    assert s.parent is None


def test_stage_timer_reads_the_recorder(caplog):
    """``StageTimer``'s stages are spans: seconds from their stamps, an
    exception still recorded, the reference's log line, and a report
    with the spans inside and the captures, replays and host syncs."""
    t = profiling.StageTimer()
    with caplog.at_level(logging.INFO, logger="pano360_tpu_torch.profiling"):
        with t.stage("Stage one"):
            with profiling.span("t.inside"):
                time.sleep(0.001)
            profiling.count("host_syncs", 2)
        with t.stage("Stage one"):
            pass
    with pytest.raises(ValueError):
        with t.stage("boom"):
            raise ValueError("x")
    assert set(t.stages) == {"Stage one", "boom"}
    assert t.stages["Stage one"] >= 1e-3
    assert any("Stage one, time:" in r.getMessage() for r in caplog.records)
    rep = t.report()
    assert "Stage one" in rep and "total" in rep and "t.inside" in rep
    assert "graphs.captures: 0" in rep and "host_syncs: 2" in rep
    assert "graphs.programs_made: 0" in rep
    assert "graphs.programs_hit: 0" in rep


def test_programs_count_made_and_hit():
    """``graphs.Programs.get`` makes a key's program once, counted in
    ``graphs.programs_made``, and hands it back at each later call of
    the key, counted in ``graphs.programs_hit``; the report has both."""
    programs = graphs.Programs()
    made = []

    def make():
        made.append(object())
        return made[-1]
    t = profiling.StageTimer()
    before = profiling.snapshot()
    first = programs.get(("t.key", 1), make)
    again = [programs.get(("t.key", 1), make) for _ in range(3)]
    other = programs.get(("t.key", 2), make)
    counters = profiling.delta(profiling.snapshot(), before)["counters"]
    assert counters["graphs.programs_made"] == 2
    assert counters["graphs.programs_hit"] == 3
    assert all(p is first for p in again) and other is made[1]
    assert len(made) == 2
    rep = t.report()
    assert "graphs.programs_made: 2" in rep
    assert "graphs.programs_hit: 3" in rep


def test_traverse_records_its_parts(world):
    """On the CPU ``traverse`` runs its steps eagerly: its five parts are
    spans under ``register`` and no graph is captured; ``stats`` has the
    spans and the totals."""
    stats = {}
    before = profiling.snapshot()
    regions = register.traverse(world["u8"], world["pts"], device=CPU,
                                stats=stats)
    assert len(regions) == 4
    spans = stats["spans"]
    assert [s[0] for s in spans] == REGISTER_PARTS + ["register"]
    assert all(p == "register" for _, p, _, _ in spans[:-1])
    assert spans[-1][1] is None
    # the parts follow one another and cover the call
    ends = [spans[-1][2]] + [e for _, _, _, e in spans[:-1]]
    for (_, _, s, _), prev_end in zip(spans[:-1], ends):
        assert s >= prev_end
    assert spans[-1][2] <= spans[0][2] and spans[-2][3] <= spans[-1][3]
    counters = profiling.delta(stats["totals"], before)["counters"]
    assert counters.get("graphs.captures", 0) == 0
    assert "graphs.capture" not in [s[0] for s in spans]
    # two an add's SVD, a read of the counters at least per LM and the
    # polish, four in straightening, two for stats, one for the cameras
    assert counters["host_syncs"] >= 2 * 3 + 3 + 1 + 4 + 2 + 1


def test_window_stages_write_their_spans(world):
    """The window's stages each record a span, and the stages given
    ``stats`` (matching, traverse) leave the process's totals in it."""
    before = profiling.snapshot()
    stats = {}
    stack, feats = pipeline.upload_extract(world["u8"], CPU)
    kpts, matches = pipeline.matching(world["u8"], CPU, feats=feats,
                                      stats=stats)
    pts = pipeline.idx_to_keypoints(matches, kpts)
    regions = register.traverse(world["u8"], pts, device=CPU, stats=stats)
    render.stitch(regions, dev_images=stack, device=CPU)
    got = profiling.delta(profiling.snapshot(), before)["spans"]
    for name in ("features", "match", "keypoints", "register", "render",
                 *REGISTER_PARTS):
        assert got[name]["count"] == 1, name
    names = [s[0] for s in stats["spans"]]
    assert names[0] == "match" and names[-1] == "register"
    assert stats["totals"]["spans"]["features"]["count"] >= 1


def _program_spans(world):
    stats = {}
    register.traverse(world["u8"], world["pts"], device=CPU, stats=stats)
    return stats


def test_annotation_off_leaves_the_profile_alone(world):
    """By default no span opens a ``record_function``: a profiler run over
    a CPU ``traverse`` holds no event named after a program span, so a
    reader of the profile's device work finds nothing new."""
    from torch.profiler import ProfilerActivity, profile
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        register.traverse(world["u8"], world["pts"], device=CPU, stats=stats)
    names = {s[0] for s in stats["spans"]}
    assert {"register", *REGISTER_PARTS} <= names
    assert not names & {e.name for e in prof.events()}


def test_annotation_on_puts_spans_on_the_profile(world):
    """Under ``annotated()`` each span is a ``record_function`` event of
    its name whose start and end lie within 50 us of the span's stamps
    (the profiler's host events are on ``time.time_ns``'s clock)."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.annotated(), profiling.span("t.warm"):
        pass
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotated():
            register.traverse(world["u8"], world["pts"], device=CPU,
                              stats=stats)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name, _, start, end in stats["spans"]:
        s, e = min(events[name], key=lambda se: abs(se[0] - start))
        assert abs(s - start) <= 50_000 and abs(e - end) <= 50_000, name
    with profiling.span("t.off"):
        pass
    assert not profiling._ANNOTATE


def test_device_trace_writes_the_spans(tmp_path):
    """``cli.device_trace`` (``--trace-dir``) annotates: the Chrome trace
    holds the program's spans."""
    with cli.device_trace(str(tmp_path)):
        with profiling.span("t.traced"):
            torch.ones(4).sum()
    with open(tmp_path / "trace.json") as fid:
        names = {e.get("name") for e in json.load(fid)["traceEvents"]}
    assert "t.traced" in names


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [dict(badjust="incr"),
                                   dict(badjust="incr", equalize=True),
                                   dict(badjust="last", crop=True),
                                   dict(badjust="incr", detector="msop",
                                        blender="linear")],
                         ids=["incr", "incr-e", "last-c", "msop-linear"])
def test_host_syncs_counted_where_they_happen_on_card(flags, monkeypatch):
    """On a warm panorama of the bench world, stage by stage, the
    ``host_syncs`` counter equals the syncs that PyTorch's sync-debug
    mode reports. With the process's programs made afresh, ``traverse``
    captures its three steps on the first panorama, each a
    ``graphs.capture`` span under ``register.lm`` or ``register.polish``,
    and none on the warm one, which replays them. Under MSOP the
    extraction runs inside the match stage and the render uploads the
    views.
    """
    from pano360_tpu_torch.measure import bench_views, host_syncs
    dev = _cuda()
    _, u8, _, _ = bench_views()
    badjust = flags.pop("badjust")
    detector = flags.pop("detector", "sift")
    monkeypatch.setattr(graphs, "PROGRAMS", graphs.Programs())

    def panorama():
        got = {}

        def stage(name, fn):
            before = profiling.snapshot()["counters"].get("host_syncs", 0)
            out, sites = host_syncs(fn)
            after = profiling.snapshot()["counters"].get("host_syncs", 0)
            got[name] = (after - before, sites)
            return out
        stats = {}
        stack = feats = None
        if detector == "sift":
            stack, feats = stage("features",
                                 lambda: pipeline.upload_extract(u8, dev))
        kpts, matches = stage("match", lambda: pipeline.matching(
            u8, dev, feats=feats, detector=detector, stats=stats))
        pts = stage("keypoints",
                    lambda: pipeline.idx_to_keypoints(matches, kpts))
        regions = stage("register", lambda: register.traverse(
            u8, pts, badjust=badjust, device=dev, stats=stats))
        stage("render", lambda: render.stitch(regions, dev_images=stack,
                                              device=dev, **flags))
        return got, stats
    _, cold = panorama()        # the captures of SIFT, match and register
    got, stats = panorama()
    table = {name: (counted, sum(sites.values()), sites)
             for name, (counted, sites) in got.items()}
    assert all(c == w for c, w, _ in table.values()), "\n".join(
        f"{name}: counted {c}, the mode saw {w}: {sites}"
        for name, (c, w, sites) in table.items())
    assert got["register"][0] > 0
    caps = [s for s in cold["spans"] if s[0] == "graphs.capture"
            and s[1] in ("register.lm", "register.polish")]
    assert len(caps) == 3
    assert not [s for s in stats["spans"] if s[0] == "graphs.capture"]
