"""gprf_torch's analysis tools, profiling and seismic data pipeline against
gprf_tpu's on the same inputs: the fleet's suites and launcher scripts, the
paper's figure series, the plots, ``python -m gprf_torch.cli.analyze``,
``device_trace`` / ``SectionTimer``, and ISF parsing, waveform alignment and
the catalog join and sort."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from gprf_tpu.analysis import fleet as jfleet
from gprf_tpu.analysis import paper_figures as jfig
from gprf_tpu.cli import gprfopt as jgprfopt
from gprf_tpu.data.pipeline import align as jalign
from gprf_tpu.data.pipeline import catalog as jcat
from gprf_tpu.data.pipeline import isf as jisf
from gprf_tpu.utils import profiling as jprof
from gprf_torch.analysis import fleet as tfleet
from gprf_torch.analysis import paper_figures as tfig
from gprf_torch.analysis import plots as tplots
from gprf_torch.cli import analyze as tanalyze
from gprf_torch.cli import gprfopt as tgprfopt
from gprf_torch.data import seismic as tseis
from gprf_torch.data.pipeline import align as talign
from gprf_torch.data.pipeline import catalog as tcat
from gprf_torch.data.pipeline import isf as tisf
from gprf_torch.utils import profiling as tprof

torch.set_num_threads(1)
SUITES = ("eighty_run_params", "truegp_run_params", "fitc_run_params")
SCRIPTS = ("run_eighty.sh", "run_truegp.sh", "run_fitc.sh")


# ---- the fleet ----------------------------------------------------------------------


@pytest.mark.parametrize("suite", SUITES)
def test_fleet_suites_equal_jax(suite):
    runs, by_key = getattr(tfleet, suite)()
    jruns, jby_key = getattr(jfleet, suite)()
    assert runs == jruns and dict(by_key) == dict(jby_key) and len(runs) >= 10


def test_gen_runs_names_the_ports_command_line(tmp_path):
    """The scripts are the reference's with one substitution, the module
    of the command line."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tfleet.gen_runs(out_dir=str(tmp_path / "t"))
    jfleet.gen_runs(out_dir=str(tmp_path / "j"))
    for name in SCRIPTS:
        ours = (tmp_path / "t" / name).read_text()
        theirs = (tmp_path / "j" / name).read_text()
        assert "gprf_tpu" not in ours and ours.count("python -m gprf_torch.cli.gprfopt ") == len(
            ours.splitlines())
        assert ours == theirs.replace("gprf_tpu.cli.gprfopt", "gprf_torch.cli.gprfopt")
    runs, _ = tfleet.truegp_run_params()
    tail = dict(analyze=True, parallel=True, maxsec=None, tail=" &")
    tfleet.gen_runexp(runs, "X", str(tmp_path / "t.sh"), **tail)
    jfleet.gen_runexp(runs, "X", str(tmp_path / "j.sh"), **tail)
    assert (tmp_path / "t.sh").read_text() == (tmp_path / "j.sh").read_text()


def test_analyze_gen_runs(tmp_path, capsys):
    tanalyze.main(["gen-runs", "--out_dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(SCRIPTS)
    assert "gprf_torch.cli.gprfopt" in (tmp_path / "run_truegp.sh").read_text()
    assert "wrote run_eighty.sh" in capsys.readouterr().out
    tanalyze.main([])
    assert "gen-runs" in capsys.readouterr().out


# ---- the paper's figures -------------------------------------------------------------


@pytest.fixture
def suite_dir(tmp_path):
    """An experiment base with results.txt for some of the truegp suite's
    runs: seeded rows (step, time, mll, dlscale, mad, ...) and a trueX row;
    one run has an empty results.txt and the rest none."""
    _, by_key = tfleet.truegp_run_params()
    rng = np.random.default_rng(7)
    picked = [run for runs in by_key.values() for run in runs][::3]
    for k, run in enumerate(picked):
        d = tmp_path / tgprfopt.build_run_name(run)
        d.mkdir()
        if k == 1:
            (d / "results.txt").write_text("")
            continue
        rows = np.column_stack([np.arange(6), np.cumsum(rng.uniform(1, 2, 6)),
                                rng.normal(size=(6, 2)), rng.uniform(0.001, 0.01, (6, 8))])
        text = "".join(" ".join("%.6f" % v for v in r) + "\n" for r in rows)
        (d / "results.txt").write_text(text + "trueX inf" + " 0.0" * 10 + "\n")
    return str(tmp_path), by_key


def test_paper_figure_series_equal_jax(suite_dir):
    base, by_key = suite_dir
    for run in (r for runs in by_key.values() for r in runs):
        assert tgprfopt.build_run_name(run) == jgprfopt.build_run_name(run)
    for ntrain in (None, 400):
        ours = tfig.suite_series(base, by_key, tgprfopt.build_run_name, ntrain=ntrain)
        theirs = jfig.suite_series(base, by_key, jgprfopt.build_run_name, ntrain=ntrain)
        assert ours.keys() == theirs.keys() and len(ours) >= 3
        for k in ours:
            for a, b in zip(ours[k], theirs[k]):
                np.testing.assert_array_equal(a, b)
    assert (tfig.final_error_vs_time(base, by_key, tgprfopt.build_run_name)
            == jfig.final_error_vs_time(base, by_key, jgprfopt.build_run_name))
    R = np.array([[0, 1.0, 0, 0, 0.3], [1, 2.0, 0, 0, 0.2], [2, 3.0, 0, 0, 0.25]])
    for a, b in zip(tfig.error_envelope(R, 4), jfig.error_envelope(R, 4)):
        np.testing.assert_array_equal(a, b)


def test_plots_render(tmp_path):
    pytest.importorskip("matplotlib")
    d = tmp_path / "run"
    d.mkdir()
    rng = np.random.default_rng(8)
    for step in range(2):
        np.save(d / ("step_%05d_X.npy" % step), rng.uniform(size=(50, 2)))
    written = tplots.vis_points(str(d), sdata=None, make_movie=False)
    assert [os.path.basename(w) for w in written] == ["step_00000_X.png", "step_00001_X.png"]
    assert all(os.path.getsize(w) > 0 for w in written)
    tplots.write_plot({"a": ([1, 2], [3, 4])}, str(tmp_path / "p.png"), ylim=(0, 5), xlim=(1, 2))
    assert os.path.getsize(tmp_path / "p.png") > 0


def test_plots_without_matplotlib(tmp_path, monkeypatch, capsys):
    """The card machine has no matplotlib: each function says so and does
    nothing, with the reference's message."""
    import sys

    for name in ("matplotlib", "matplotlib.figure", "matplotlib.backends.backend_agg"):
        monkeypatch.setitem(sys.modules, name, None)
    assert tplots.vis_points(str(tmp_path)) == []
    assert tplots.write_plot({}, str(tmp_path / "p.png")) is None
    out = capsys.readouterr().out
    assert "matplotlib unavailable; skipping vis_points" in out
    assert "matplotlib unavailable; skipping write_plot" in out
    tanalyze.main(["vis", str(tmp_path), "--no_movie"])
    assert "wrote 0 frames" in capsys.readouterr().out


# ---- profiling -----------------------------------------------------------------------


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(None):
        pass
    assert os.listdir(tmp_path) == []
    log_dir = tmp_path / "trace"
    with tprof.device_trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(log_dir)
    assert name.startswith("trace-") and name.endswith(".json")
    with open(log_dir / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_section_timer_summary_matches_jax():
    t, j = tprof.SectionTimer(), jprof.SectionTimer()
    for timer in (t, j):
        with timer.section("a"):
            pass
        with timer.section("b"):
            pass
        with timer.section("a"):
            pass
        timer.totals.update(a=2.5, b=0.25)
    assert t.summary() == j.summary() == "a 2.500s/2; b 0.250s/1"


# ---- the seismic data pipeline -------------------------------------------------------

ISF_LINE = ("2009/04/06 01:32:39.00   0.50  0.30  42.3340   13.3340  2.0   1.5  90  8.8f   1.0"
            + " " * 30)
ISF_LINE = ISF_LINE[:113] + "a" + "    ISCTEST  " + " 123456"


def test_isf_parsing_equals_jax():
    assert tisf.ev_from_line(ISF_LINE) == jisf.ev_from_line(ISF_LINE)
    short = ISF_LINE[:60]  # no strike, depth or source: the defaults
    assert tisf.ev_from_line(short) == jisf.ev_from_line(short)
    page = "<html><pre>\n" + ISF_LINE + "\n" + ISF_LINE.replace("ISCTEST", "IDC    ") + "\nSTOP"
    assert tisf.extract_ev(page) == jisf.extract_ev(page)
    for bad in ("No events were found", "<pre>\nnothing\nSTOP"):
        with pytest.raises(tisf.CouldNotScrapeException):
            tisf.extract_ev(bad)
    for args in ((0, 0, 10, 3.0), (1, 2, 30, 6.0)):
        assert tisf.fakescrape(*args) == jisf.fakescrape(*args)
    assert tisf.isc_query_url(130.5, -3.25, 1.3e9) == jisf.isc_query_url(130.5, -3.25, 1.3e9)


def test_xcorr_and_alignment_equal_jax():
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=50), rng.normal(size=300)
    np.testing.assert_array_equal(talign.my_xc(a, b), jalign.my_xc(a, b))
    assert talign.xcorr_valid(a, b)[:2] == jalign.xcorr_valid(a, b)[:2]
    assert len(talign.my_xc(b, a)) == 0
    src = rng.normal(size=400)
    w1, w2 = src[:350], np.concatenate([np.zeros(7), src])[:350]
    assert talign.align(w1, w2) == jalign.align(w1, w2)
    waves = []
    for s in (0, 4, -3, 7, 2):
        w = rng.normal(size=400) * 0.05
        w[85 + s:85 + s + 200] += src[:200]
        waves.append(w)
    for x, y in zip(talign.offsets(waves), jalign.offsets(waves)):
        np.testing.assert_array_equal(x, y)
    assert talign.coherency(waves, np.full(5, 85.0)) == jalign.coherency(waves, np.full(5, 85.0))
    runs = []
    for mod in (talign, jalign):
        np.random.seed(0)
        runs.append(mod.align_waves(waves, nruns=2, threshold=0.3, rng=np.random))
    assert runs[0][0] == runs[1][0] and runs[0][0] > 0.5
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    pytest.importorskip("sklearn")
    ll = rng.uniform(size=(40, 2))
    np.testing.assert_array_equal(talign.cluster_locations(ll, 3), jalign.cluster_locations(ll, 3))


def _write_csv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(", ".join("%f" % v for v in r) + "\n")


def test_catalog_join_and_sort_equals_jax(tmp_path):
    """Scraped ISC and IDC tables (one outlier, one ISC-only event) joined,
    filtered and Morton-sorted; generate_sorted writes the sorted_isc.npy
    that load_data reads."""
    rng = np.random.default_rng(10)
    isc_rows, idc_rows = [], []
    for k in range(30):
        lon, lat = 120 + rng.uniform(0, 20), -5 + rng.uniform(0, 10)
        base = [k, 1000 + k, 1e9 + k, 0.5, lon, lat, 20.0, 15.0, 0, 30.0, 2.0]
        isc_rows.append(base)
        idc = list(base)
        idc[4] += 10.0 if k == 3 else 0.05
        idc_rows.append(idc)
    isc_rows.append([99, 2000, 1e9, 0.5, 140.0, 0.0, 20.0, 15.0, 0, 30.0, 2.0])
    _write_csv(tmp_path / "isc.txt", isc_rows)
    _write_csv(tmp_path / "idc.txt", idc_rows)
    isc_d = tcat.scraped_to_evid_dict(str(tmp_path / "isc.txt"))
    assert isc_d == jcat.scraped_to_evid_dict(str(tmp_path / "isc.txt"))
    idc_d = tcat.scraped_to_evid_dict(str(tmp_path / "idc.txt"))
    ours, theirs = tcat.join_and_sort(isc_d, idc_d), jcat.join_and_sort(isc_d, idc_d)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert len(ours[2]) == 29 and 1003 not in ours[2] and 2000 not in ours[2]
    (tmp_path / "out").mkdir()
    tcat.generate_sorted(str(tmp_path / "isc.txt"), str(tmp_path / "idc.txt"),
                         out_dir=str(tmp_path / "out"))
    for name, arr in zip(("sorted_idc", "sorted_isc", "sorted_evids"), ours):
        np.testing.assert_array_equal(np.load(tmp_path / "out" / f"{name}.npy"), arr)
    # the catalog the seismic experiment reads (its Y drawn over these events)
    cat, SY, _ = tseis.load_data(40.0, 0, data_dir=str(tmp_path / "out"))
    np.testing.assert_array_equal(cat, ours[1])
    assert SY.shape == (29, 50)


def test_combine_clusters_and_load_events_equal_jax(tmp_path):
    rng = np.random.default_rng(11)
    d = tmp_path / "clusters"
    d.mkdir()
    for i in (0, 2):
        for part, shape in (("X", (3, 3)), ("Y", (3, 5)), ("Data", (3, 7))):
            np.save(d / ("cluster_%03d_%s.npy" % (i, part)), rng.normal(size=shape))
    ours = tcat.combine_clusters(str(d), max_clusters=4)
    theirs = jcat.combine_clusters(str(d), max_clusters=4)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape == (6, 3) and os.path.exists(d / "aligned_data.npy")
    ev = tmp_path / "events"
    ev.mkdir()
    for name, items in (("mkar_stuff_10", [1, 2]), ("mkar_stuff_20", [3]),
                        ("mkar_stuff_final", [4])):
        with open(ev / name, "wb") as f:
            pickle.dump(items, f)
    assert tcat.load_events(str(ev), bin_size=10) == jcat.load_events(str(ev), bin_size=10) == [
        1, 2, 3, 4]
