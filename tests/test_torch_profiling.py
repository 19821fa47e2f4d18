"""The port's spans and counters (`tomojax_torch.profiling`) on the CPU:
nothing is recorded without a profiler; under one, each public call's
span tree, its counts, the spans' place on the profiler's clock, and
outputs identical to the unprofiled run."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tomojax_torch import (
    ChemicalTomo, DynamicReconstructor, TomoTorch, profiling,
)
from tomojax_torch.geometry import Geometry
from tomojax_torch.projector import cuda_joseph

NS, N, NA, NC = 4, 16, 6, 5  # slices, rays, HAADF tilts, chemistry tilts
FISTA_IT, ASD_IT, CHEM_IT, FUSION_IT, LIVE_IT = 3, 3, 2, 3, 2
HAADF_DEG = np.linspace(-60.0, 60.0, NA)
CHEM_DEG = np.linspace(-50.0, 50.0, NC)


def _series(seed: int, na: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (NS, N, na)).astype(np.float32)


def _fista():
    t = TomoTorch(HAADF_DEG, _series(1, NA), device="cpu")
    t.fista(FISTA_IT, nTViter=3)
    return {"recon": t.get_recon(), "cost": t.cost}


def _asd_pocs():
    t = TomoTorch(HAADF_DEG, _series(2, NA), device="cpu")
    t.asd_pocs(ASD_IT, nTViter=2)
    return {"recon": t.get_recon(), "dd": t.dd_vec, "tv": t.tv_vec}


def _fusion():
    c = ChemicalTomo(_series(3, NA), HAADF_DEG,
                     {"C": _series(4, NC), "Zn": _series(5, NC)}, CHEM_DEG,
                     device="cpu")
    c.chemical_tomography(CHEM_IT)
    c.data_fusion(FUSION_IT, iterSIRT=2, tvIter=2)
    return {"recon": c.get_recon(), "haadf": c.costHAADF,
            "chem": c.costCHEM}


def _live():
    rec = DynamicReconstructor(N, NA, device="cpu", alg="cs")
    series = _series(6, NA)
    dds = []
    for k in range(NA):
        rec.add_projections([(float(HAADF_DEG[k]), series[:, :, k])])
        dds.append(rec.iterate_cs(LIVE_IT, ng=2))
    return {"recon": rec.get_recon(), "dd": np.asarray(dds)}


JOBS = {"fista": _fista, "asd_pocs": _asd_pocs, "fusion": _fusion,
        "live": _live}


def _profiled(job):
    """(outputs, spans, profiler) of `job` under torch.profiler on the
    CPU, the store cleared first."""
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = job()
    spans = list(profiling.recorded().spans)
    profiling.recorded().clear()
    return out, spans, prof


def _children(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


def _names(spans) -> list:
    return [s.name for s in spans]


def _root_of(spans):
    """Every span's root is the outermost span above it."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
        assert s.root == top.id, s


# ---------------------------------------------------------------- off


def test_annotate_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.annotate("api.a"), profiling.annotate("solvers.b")
    assert a is b
    profiling.recorded().clear()
    with a:
        profiling.count("reads")
    assert len(profiling.recorded().spans) == 0


@pytest.mark.parametrize("job", list(JOBS))
def test_jobs_record_nothing_without_a_profiler(job):
    profiling.recorded().clear()
    JOBS[job]()
    assert len(profiling.recorded().spans) == 0
    assert profiling.recorded().spans_dropped == 0


# ----------------------------------------------------------------- on


def test_fista_job_span_tree():
    _, spans, _ = _profiled(_fista)
    _root_of(spans)
    kids = _children(spans)
    roots = kids[None]
    assert _names(roots) == ["api.TomoTorch", "api.fista", "api.get_recon"]
    build, fista, get = roots
    assert sorted(_names(kids[build.id])) == ["api.h2d", "api.sinogram",
                                              "api.system"]
    assert _names(kids[fista.id]) == (["solvers.iteration"] * FISTA_IT
                                      + ["api.d2h"])
    for it in kids[fista.id][:-1]:
        assert _names(kids[it.id]) == ["tv.prox"]
    assert kids[fista.id][-1].counts == {"reads": 1}
    assert _names(kids[get.id]) == ["api.d2h"]
    assert kids[get.id][0].counts == {"reads": 1}
    # two reads a job: the cost vector and the volume
    reads = sum(s.counts.get("reads", 0) for s in spans)
    assert reads == 2


def test_asd_pocs_job_span_tree_and_reads_per_iteration():
    _, spans, _ = _profiled(_asd_pocs)
    _root_of(spans)
    kids = _children(spans)
    assert _names(kids[None]) == ["api.TomoTorch", "api.asd_pocs",
                                  "api.get_recon"]
    job = kids[None][1]
    its = kids[job.id]
    assert _names(its) == ["solvers.iteration"] * ASD_IT
    for it in its:
        assert _names(kids[it.id]) == ["tv.descent", "solvers.read"]
        read = kids[it.id][1]
        # dp, dd, dg, the dPOCS used and the TV value in one stacked read
        assert read.counts == {"reads": 1}
    n_it = sum(s.name == "solvers.iteration" for s in spans)
    reads = sum(s.counts.get("reads", 0) for s in spans)
    assert reads == n_it + 1  # and the volume


def test_chemical_tomo_job_span_tree_and_reads_per_iteration():
    _, spans, _ = _profiled(_fusion)
    _root_of(spans)
    kids = _children(spans)
    assert _names(kids[None]) == ["api.ChemicalTomo",
                                  "api.chemical_tomography",
                                  "api.data_fusion", "api.get_recon"]
    build, chem, fusion, _ = kids[None]
    assert sorted(_names(kids[build.id])) == ["api.h2d", "api.h2d",
                                              "api.sinogram", "api.system"]
    assert _names(kids[chem.id]) == (["solvers.iteration"] * CHEM_IT
                                     + ["api.d2h"])
    assert _names(kids[fusion.id]) == ["solvers.iteration"] * FUSION_IT
    for it in kids[chem.id][:-1]:
        # each Poisson-ML step is the chemistry side alone
        assert _names(kids[it.id]) == ["fusion.chem"]
    for it in kids[fusion.id]:
        # the step's HAADF and chemistry sides, one prox per element, then
        # the three costs in one read
        assert _names(kids[it.id]) == ["fusion.haadf", "fusion.chem",
                                       "tv.prox", "tv.prox",
                                       "solvers.read"]
        assert kids[it.id][-1].counts == {"reads": 1}
    n_it = sum(s.name == "solvers.iteration" for s in spans)
    assert n_it == CHEM_IT + FUSION_IT
    reads = sum(s.counts.get("reads", 0) for s in spans)
    assert reads == 1 + FUSION_IT + 1  # costCHEM, the loop, the volume


def test_live_updates_span_tree_and_plan_builds_per_angle_set():
    cuda_joseph.angle_tables.cache_clear()
    cuda_joseph._fp_plan.cache_clear()
    _, spans, _ = _profiled(_live)
    _root_of(spans)
    kids = _children(spans)
    roots = kids[None]
    # the rounds, then get_recon's read of the volume
    assert _names(roots) == (["api.add_projections", "api.iterate_cs"] * NA
                             + ["api.d2h"])
    assert roots[-1].counts == {"reads": 1}
    for r in roots[1:-1:2]:
        assert _names(kids[r.id]) == (["api.system", "api.fill"]
                                      + ["solvers.iteration"] * LIVE_IT)
        assert kids[r.id][1].counts == {}  # the fill
        for it in kids[r.id][2:]:
            assert _names(kids[it.id]) == ["tv.descent", "solvers.read"]
            assert kids[it.id][1].counts == {"reads": 1}
    # each tilt is a new angle set: on the CPU one table build an update
    # (the plain projectors read the host tables); on the card K1's plan
    # and the device tables add two (test below)
    builds = sum(s.counts.get("plan_builds", 0) for s in spans)
    assert builds == NA
    for s in spans:
        if "plan_builds" in s.counts:
            assert s.name == "api.system"


def test_plan_builds_count_cache_misses_only():
    geom = Geometry.make(N, np.deg2rad(np.linspace(-70.0, 70.0, 7)))
    cpu = torch.device("cpu")
    cuda_joseph.angle_tables.cache_clear()
    cuda_joseph._fp_plan.cache_clear()

    def calls():
        with profiling.annotate("api.system") as span:
            # K1's wrappers on the card: the device tables, then the plan,
            # which builds from the host tables
            cuda_joseph.angle_tables(geom, cpu)
            cuda_joseph.fp_plan(geom, cpu)
            cuda_joseph.fp_plan(geom, cpu)
            cuda_joseph.angle_tables(geom, cpu)
        return span

    with profile(activities=[ProfilerActivity.CPU]):
        first, again = calls(), calls()
    # the host tables once, the plan once; every later call is a hit
    assert first.counts == {"plan_builds": 2}
    assert again.counts == {}


def test_spans_lie_inside_their_profiler_events():
    _, spans, prof = _profiled(_fista)
    base = prof.profiler.kineto_results.trace_start_ns()
    events = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            events[e.name].append(e)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    assert set(by_name) <= set(events)
    for name, mine in by_name.items():
        theirs = sorted(events[name], key=lambda e: e.time_range.start)
        mine.sort(key=lambda s: s.start_ns)
        assert len(theirs) == len(mine), name
        for s, e in zip(mine, theirs):
            # the event's microseconds after the trace's start, with a
            # microsecond for the rounding of its stamps
            assert base + 1e3 * (e.time_range.start - 1) <= s.start_ns
            assert s.start_ns <= s.end_ns
            assert s.end_ns <= base + 1e3 * (e.time_range.end + 1)


@pytest.mark.parametrize("job", list(JOBS))
def test_outputs_are_identical_with_and_without_the_profiler(job):
    plain = JOBS[job]()
    traced, spans, _ = _profiled(JOBS[job])
    assert spans
    assert plain.keys() == traced.keys()
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)


# ------------------------------------------------------------ recorder


def test_counts_go_to_the_innermost_open_span():
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("api.outer") as outer:
            profiling.count("reads")
            with profiling.annotate("solvers.inner") as inner:
                profiling.count("reads", 2)
                profiling.count("reads")
            profiling.count("plan_builds")
    assert inner.counts == {"reads": 3}
    assert outer.counts == {"reads": 1, "plan_builds": 1}
    assert (inner.parent, inner.root) == (outer.id, outer.id)
    assert (outer.parent, outer.root) == (None, outer.id)
    assert _names(profiling.recorded().spans) == ["solvers.inner",
                                                  "api.outer"]
    profiling.recorded().clear()


def test_a_span_keeps_its_childrens_entries_and_exits_apart():
    """`inner_ns` holds the host time of the direct children's entries and
    exits outside their stamps, so that a span's self time (its duration
    less its children and `inner_ns`) leaves the instrumentation out."""
    profiling.recorded().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("api.outer") as outer:
            for _ in range(20):
                with profiling.annotate("solvers.inner"):
                    pass
    inner = [s for s in profiling.recorded().spans
             if s.name == "solvers.inner"]
    assert len(inner) == 20
    assert all(s.inner_ns == 0 for s in inner)  # no children of their own
    children = sum(s.end_ns - s.start_ns for s in inner)
    assert outer.inner_ns > 0
    assert children + outer.inner_ns <= outer.end_ns - outer.start_ns
    profiling.recorded().clear()


def test_store_drops_its_oldest_spans_and_counts_them():
    store = profiling.Store(limit=3)
    spans = [profiling.Span(f"s{i}") for i in range(5)]
    for s in spans:
        store.add(s)
    assert list(store.spans) == spans[2:]
    assert store.spans_dropped == 2
    store.clear()
    assert len(store.spans) == 0 and store.spans_dropped == 0


def test_trace_clears_the_store_on_entry(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("api.before"):
            pass
    assert _names(profiling.recorded().spans) == ["api.before"]
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("api.inside"):
            torch.ones(8).sum()
    assert _names(profiling.recorded().spans) == ["api.inside"]
    profiling.recorded().clear()


def test_spanned_keeps_the_function_and_opens_its_span():
    assert TomoTorch.fista.__name__ == "fista"
    assert "FISTA-TV" in TomoTorch.fista.__doc__

    @profiling.spanned("api.job")
    def job(a, b=2):
        """Doc."""
        with profiling.annotate("api.inner"):
            return a + b

    assert job.__name__ == "job" and job.__doc__ == "Doc."
    assert job(1) == 3  # no profiler: nothing recorded
    assert len(profiling.recorded().spans) == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert job(1, b=5) == 6
    inner, outer = profiling.recorded().spans
    assert (outer.name, inner.name) == ("api.job", "api.inner")
    assert inner.parent == outer.id
    profiling.recorded().clear()


@pytest.mark.cuda
def test_series_reorder_on_the_card_equals_the_host_transpose():
    """On the card at the job cells' sizes: a (256, 256, 77) float32 series
    crosses with no host copy ("series_host_copies" reads 0) and b_sl
    equals numpy's transpose bit for bit; ChemicalTomo's clamp, division
    by the maximum and reorder of a (128, 256, 77) HAADF series and two
    (128, 256, 9) maps (one all zero) equal numpy's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def host(a, normalise=False):
        if normalise:
            a = np.maximum(a, 0)
            a = a / max(a.max(), 1e-30)
        return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))

    def same_bits(t, want):
        assert t.is_cuda and t.is_contiguous()
        np.testing.assert_array_equal(t.cpu().numpy().view(np.uint32),
                                      want.view(np.uint32))

    rng = np.random.default_rng(7)
    deg, chem_deg = np.linspace(-76.0, 76.0, 77), np.linspace(-60, 60, 9)
    ts = rng.uniform(-0.5, 2.0, (256, 256, 77)).astype(np.float32)
    maps = {"c": rng.uniform(-0.5, 3.0, (128, 256, 9)).astype(np.float32),
            "zn": np.zeros((128, 256, 9), np.float32)}
    (tomo, ct), spans, _ = _profiled(lambda: (
        TomoTorch(deg, ts, device="cuda"),
        ChemicalTomo(ts[:128], deg, maps, chem_deg, device="cuda")))
    assert sum(s.counts.get("series_host_copies", 0) for s in spans) == 0
    same_bits(tomo.b_sl, host(ts))
    same_bits(ct.b_haadf, host(ts[:128], True))
    same_bits(ct.b_chem, np.stack([host(m, True) for m in maps.values()]))
