"""PyTorch port, utils/trace.py and the engine's spans and counters on the
CPU: no record_function outside a profiler; inside one, the `pyrhe.*`
spans of a cached and a streaming estimate, nested as the engine opens
them; the always-on counters (engine_init_s, prefetch_wait_s,
blocks_read) and the traced ones (block_stats_s, assemble_s);
profile_run.by_span's attribution of device time to the innermost span;
and the same σ² and jackknife samples, bit for bit, with tracing on and
off."""
import numpy as np
import pytest
import torch

from pyrhe_tpu_torch.core.data import load_dataset
from pyrhe_tpu_torch.core.engine import Engine, ModelSpec, RunConfig
from pyrhe_tpu_torch.profile_run import by_span
from pyrhe_tpu_torch.utils import trace

torch.set_num_threads(2)

J, B = 6, 6
CPU = [torch.profiler.ProfilerActivity.CPU]


def engine(ds, model="rhe", streaming=False, cov=True, **cfg):
    env = model == "genie"
    data = load_dataset(ds["prefix"], annot_file=ds["annot1_path"],
                        pheno_file=ds["pheno_path"],
                        cov_file=ds["cov_path"] if cov else None,
                        env_file=ds["env_path"] if env else None,
                        num_random_vec=B, seed=5)
    spec = ModelSpec.build(model, "G+GxE+NxE" if env else "G",
                           data.num_env)
    return Engine(data, spec, RunConfig(num_random_vec=B, num_jack=J,
                                        seed=5, device="cpu",
                                        streaming=streaming, **cfg))


def estimate(ds, **kw):
    eng = engine(ds, **kw)
    eng.run_precompute_and_assemble()
    return eng


def spans(prof):
    """[(name, start, end, thread)] of the pyrhe.* spans, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(trace.PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def parent(evs, ev):
    """The innermost span of evs on ev's thread that holds ev, or None."""
    best = None
    for other in evs:
        if (other is not ev and other[3] == ev[3] and other[1] <= ev[1]
                and ev[2] <= other[2]
                and (best is None or other[1] >= best[1])):
            best = other
    return best


def named(evs, name):
    return [e for e in evs if e[0] == trace.PREFIX + name]


def parents(evs, name):
    return sorted({parent(evs, e)[0] if parent(evs, e) else None
                   for e in named(evs, name)})


# ------------------------------------------------------------ the helper
def test_no_record_function_outside_a_profiler(small_dataset, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not trace.tracing()
    assert trace.span("block") is trace.span("sample")
    timer = trace.DeviceTimer(torch.device("cpu"))
    assert timer.span("block_stats", "block_stats_s") is trace.span("gram")
    estimate(small_dataset)
    estimate(small_dataset, streaming=True)
    assert calls == []
    with torch.profiler.profile(activities=CPU):
        assert trace.tracing()
        with trace.span("block"):
            pass
    assert calls == [("pyrhe.block",)]


def test_device_timer_sums_its_spans_per_key_on_the_cpu():
    timer = trace.DeviceTimer(torch.device("cpu"))
    for key in ("a_s", "b_s", "a_s"):
        with timer.span("x", key, always=True):
            pass
    with timer.span("x", "c_s"):          # tracing off: not timed
        pass
    out = timer.resolve()
    assert sorted(out) == ["a_s", "b_s"] and all(v >= 0 for v in
                                                 out.values())
    assert timer.resolve() == {}


class _Ev:
    """A stand-in for a profile's kineto event."""

    def __init__(self, name, start, dur, thread=1, corr=0, device=False):
        self._v = (name, start, dur, thread, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU


def _launch(t, corr, dur_ns, name="cudaLaunchKernel", kernel="k"):
    """A runtime launch call on a CUPTI thread at t and its device work."""
    return [_Ev(name, t, 5, thread=4242, corr=corr),
            _Ev(kernel, 10_000 + t, dur_ns, thread=7, corr=corr,
                device=True)]


def test_by_span_counts_device_time_under_the_innermost_span():
    evs = [_Ev("pyrhe.precompute", 0, 1000), _Ev("pyrhe.block", 100, 300),
           _Ev("pyrhe.block_stats", 150, 100),
           _Ev("pyrhe.assemble", 2000, 900),
           _Ev("pyrhe.sample", 2000, 500), _Ev("pyrhe.gram", 2100, 100),
           # another thread's span over the same time takes nothing
           _Ev("pyrhe.host_read", 0, 5000, thread=2),
           # the mirror of a span on the device is no work
           _Ev("pyrhe.gram", 12_100, 100, thread=7, corr=99, device=True),
           # an aten op that shares a launch's id is no launch
           _Ev("aten::mul", 2150, 10, corr=5)]
    evs += _launch(160, 1, 3000)                # in block_stats
    evs += _launch(300, 2, 500, name="cudaMemcpyAsync")   # in block
    evs += _launch(400, 3, 40)                  # block ended: precompute
    evs += _launch(2100, 4, 2000)               # gram opens at 2100
    evs += _launch(2150, 5, 1500, name="cuLaunchKernel")  # gram
    evs += _launch(2499, 6, 70)                 # sample
    evs += _launch(5000, 7, 8)                  # outside every span
    evs.append(_Ev("k", 20_000, 9, thread=7, corr=8, device=True))
    got = by_span(evs)
    assert [name for name, _ in got] == [
        "pyrhe.gram", "pyrhe.block_stats", "pyrhe.block", "pyrhe.sample",
        "pyrhe.precompute", "-"]
    assert [sec for _, sec in got] == pytest.approx(
        [3500e-9, 3000e-9, 500e-9, 70e-9, 40e-9, 17e-9])


@pytest.mark.parametrize("streaming", [False, True])
def test_by_span_follows_the_engine_spans(small_dataset, streaming):
    with torch.profiler.profile(activities=CPU) as prof:
        estimate(small_dataset, streaming=streaming)
    events = list(prof.profiler.kineto_results.events())
    assert by_span(events) == []            # no device activity here
    # a microsecond of device work launched inside every multiply
    muls = [e for e in events if e.name() == "aten::mul"]
    for k, e in enumerate(muls, 10**9):
        events += _launch(e.start_ns() + e.duration_ns() // 2, k, 1000)
    got = dict(by_span(events))
    assert {"pyrhe.sample_contract", "pyrhe.cov_gram"} <= set(got)
    assert all(k.startswith(trace.PREFIX) for k in got)
    assert sum(got.values()) == pytest.approx(len(muls) * 1e-6)


# --------------------------------------------------------- engine spans
@pytest.mark.parametrize("streaming", [False, True])
def test_engine_spans_nest_as_opened(small_dataset, streaming):
    with torch.profiler.profile(activities=CPU) as prof:
        estimate(small_dataset, streaming=streaming)
    evs = spans(prof)
    (init,) = named(evs, "engine_init")
    for child in ("plan_cache", "static_arrays", "host_cache_init",
                  "m_matrix"):
        assert parents(evs, child) == ["pyrhe.engine_init"], child
    assert parents(evs, "stage1_colsum") == ["pyrhe.static_arrays"]
    assert named(evs, "checkpoint_open") == named(evs, "nxe_stats") == []
    (pre,) = named(evs, "precompute")
    (asm,) = named(evs, "assemble")
    assert init[2] <= pre[1] and pre[2] <= asm[1]

    blocks = named(evs, "block")
    assert len(blocks) == 2 * J
    pass1 = [b for b in blocks if b[2] <= pre[2]]
    pass2 = [b for b in blocks if b[1] >= asm[1]]
    assert len(pass1) == len(pass2) == J
    assert {parent(evs, b)[0] for b in blocks} == {"pyrhe.precompute",
                                                   "pyrhe.assemble"}
    computed = pass1 + (pass2 if streaming else [])
    for name in ("prefetch_wait", "block_stats"):
        assert parents(evs, name) == ["pyrhe.block"]
        assert sorted(parent(evs, e) for e in named(evs, name)) == sorted(
            computed), name
    # a cached pass 2 pops each block's stats from the device cache
    assert len(named(evs, "block_stats")) == len(computed)

    samples = named(evs, "sample")
    assert len(samples) == J + 1
    assert parents(evs, "sample") == ["pyrhe.assemble"]
    for name in ("loo_sub", "assemble_Tq"):
        assert parents(evs, name) == ["pyrhe.sample"]
        assert len(named(evs, name)) == J + 1
    for name in ("sample_contract", "cov_gram"):
        assert parents(evs, name) == ["pyrhe.assemble_Tq"], name
        assert len(named(evs, name)) == J + 1
    assert parents(evs, "results") == ["pyrhe.assemble"]
    assert parents(evs, "sync") == ["pyrhe.assemble", "pyrhe.precompute"]


def test_genie_and_a_checkpoint_add_their_spans(small_dataset, tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        engine(small_dataset, model="genie",
               checkpoint_dir=str(tmp_path / "ck"))
    evs = spans(prof)
    assert parents(evs, "nxe_stats") == ["pyrhe.static_arrays"]
    assert parents(evs, "checkpoint_open") == ["pyrhe.engine_init"]


def test_the_prefetch_thread_reads_and_cleans_in_its_spans(small_dataset):
    with trace.profiler(CPU) as prof:
        eng = estimate(small_dataset, streaming=True, host_cache_gb=1.0)
    evs = spans(prof)
    main = named(evs, "engine_init")[0][3]
    for name in ("host_read", "clean"):
        got = named(evs, name)
        # pass 2 is served from the host cache: J reads, none of them on
        # the main thread
        assert len(got) == J and all(e[3] != main for e in got)
    assert eng.phase_times["blocks_read"] == J


# ----------------------------------------------------------- counters
@pytest.mark.parametrize("streaming,host_cache_gb,reads", [
    (False, -1.0, J), (True, 1.0, J), (True, 0.0, 2 * J)])
def test_always_on_counters(small_dataset, streaming, host_cache_gb, reads):
    eng = estimate(small_dataset, streaming=streaming,
                   host_cache_gb=host_cache_gb)
    pt = eng.phase_times
    assert pt["blocks_read"] == reads
    assert pt["engine_init_s"] > 0 and pt["prefetch_wait_s"] >= 0
    assert pt["prefetch_wait_s"] <= pt["pass1_s"] + pt["pass2_s"]
    assert pt["h2d_s"] == 0.0
    assert "block_stats_s" not in pt and "assemble_s" not in pt


@pytest.mark.parametrize("streaming", [False, True])
def test_traced_counters(small_dataset, streaming):
    with torch.profiler.profile(activities=CPU):
        eng = estimate(small_dataset, streaming=streaming)
    pt = eng.phase_times
    assert 0 < pt["block_stats_s"] <= pt["pass1_s"] + pt["pass2_s"]
    assert 0 < pt["assemble_s"] <= pt["pass2_s"]


# ------------------------------------------------------------- bitwise
@pytest.mark.parametrize("model", ["rhe", "genie"])
@pytest.mark.parametrize("streaming", [False, True])
def test_tracing_changes_no_bit(small_dataset, model, streaming):
    off = estimate(small_dataset, model=model, streaming=streaming)
    with torch.profiler.profile(activities=CPU):
        on = estimate(small_dataset, model=model, streaming=streaming)
    assert np.array_equal(on.T_all, off.T_all)
    assert np.array_equal(on.q_all, off.q_all)
    jack_on, tot_on = on.estimate(0)
    jack_off, tot_off = off.estimate(0)
    assert np.array_equal(jack_on, jack_off)
    assert np.array_equal(tot_on, tot_off)
