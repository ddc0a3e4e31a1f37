"""The harness: files found by name, a cell added as data alone, the
result line's keys, no JAX in the run's process, the frozen kernel
arithmetic."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, CELLS, ROOT, STREAM, tiny

import run as bench_run
from benchlib import spec, work

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    entry = next(w for w in _bench()["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert c.traffic["driver"] in bench_run.drivers.DRIVERS
    assert set(c.limits) == {"mismatch_share", "depth_rel_gap"}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.load_module("layer_metrics", m["name"]).read)
    for m in c.end_to_end:
        assert callable(spec.load_module("end_to_end", m["name"]).read)


def test_benchmark_json_follows_its_files():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    layers = {m["name"] for m in bench["per_layer"]}
    for name in layers:
        assert os.path.exists(os.path.join(BENCH, "layer_metrics", name + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))


def test_new_cell_is_data_alone(tmp_path):
    """A cell added by a new traffic file, a limits file and an entry:
    found with no change to any file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark")
    bench = _bench()
    traffic = root / "benchmark" / "traffic" / "pair_small_pool.json"
    with open(os.path.join(BENCH, "traffic", "pair_closed_loop.json")) as fh:
        mix = json.load(fh)
    traffic.write_text(json.dumps(dict(mix, pool=2)))
    (root / "benchmark" / "limits" / "pair.small_pool.json").write_text(
        json.dumps({"mismatch_share": 0.0, "depth_rel_gap": 0.0}))
    bench["workloads"].append({"name": "pair.small_pool", "config": "sgbm_1080p_128d",
                               "traffic": "pair_small_pool", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("pair.small_pool", root=str(root))
    assert c.traffic["pool"] == 2 and c.config["name"] == "sgbm_1080p_128d"
    # Metrics with a workloads key leave the new cell out; those without
    # one reach it.
    assert {m["name"] for m in c.end_to_end} == {
        m["name"] for m in bench["end_to_end"] if "workloads" not in m}
    assert c.per_layer == []


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    c = tiny("pair.northstar_1080p_128d")
    res = bench_run.run(c, 2**31 + 17, 1, trace, torch.device("cpu"))
    want = RESULT_KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"throughput", "latency_p95_ms", "setup_s"} <= set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["checks"]) == {"mismatch_share", "depth_rel_gap"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_jax_in_the_run():
    """A run's process (the program, the harness, the reference) loads
    no module whose top-level name is jax, jaxlib, flax or the JAX
    package; the port's own name begins with the JAX package's, so names
    are compared whole."""
    code = (
        "import sys; sys.path[:0] = [{bench!r}, {root!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from conftest import tiny\n"
        "import run\n"
        "res = run.run(tiny({stream!r}), 5, 1, True, torch.device('cpu'))\n"
        "assert res['correct'], res\n"
        "assert 'depthestimation_torch' in sys.modules\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(bench=BENCH, root=ROOT, stream=STREAM)
    env = dict(os.environ, PYTHONPATH=os.path.join(BENCH, "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = eval(out.stdout.strip().splitlines()[-1])
    assert not set(top) & {"jax", "jaxlib", "flax", "depthestimation_tpu"}
    assert bench_run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(bench_run.FORBIDDEN))


def test_kernel_work_reproduces_the_bounds():
    """At 1080x1920x128 the frozen byte counts give PERF.md's K1 0.163,
    K2 0.317 and K3 0.475 ms."""
    h, w, d = 1080, 1920, 128
    got = [work.bound_ms(*work.kernel_work(k, h, w, d)) for k in
           ("cost_volume", "hscan", "rowsweep")]
    assert [round(g, 3) for g in got] == [0.163, 0.317, 0.475]
    cfg = spec.load_cell(CELLS[0]).config
    per_launch = work.sgm_launch_bounds(cfg)
    assert per_launch["hscan"] * 2 == pytest.approx(got[1])
    assert per_launch["rowsweep"] == pytest.approx(got[2])


def test_kernel_names():
    demangled = "void (anonymous namespace)::hscan_kernel<4, true, short>(short const*, int)"
    assert work.base_name(demangled) == "hscan_kernel"
    assert work.base_name("_Z18cost_volume_kernelILi5ELb0EEvPKfS1_Psiiiif") == \
        "cost_volume_kernel"
    assert work.is_sgm("void (anonymous namespace)::rowsweep_kernel<4, short, short>(int)")
    assert work.is_hand_written("void remap_kernel<true>(float const*)")
    assert not work.is_hand_written(
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)")
    assert work.is_copy("Memcpy DtoH (Device -> Pageable)")
