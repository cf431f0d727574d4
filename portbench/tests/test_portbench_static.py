"""What needs neither the port nor a card: the seeded traffic, the band
work model, the benchmark's files against BENCHMARK.json, and that the
harness and the reference load no JAX."""
import ast
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness import registry
from portbench.harness.traffic import StateStream
from portbench.harness.work import band_bound_s, band_work

ROOT = registry.ROOT
BENCH = registry.load_benchmark()


def _stream(traffic_name, cfg_name, seed):
    cfg = registry.load_json(ROOT / "portbench" / "configs"
                             / f"{cfg_name}.json")
    traffic = registry.load_json(ROOT / "portbench" / "traffic"
                                 / f"{traffic_name}.json")
    return StateStream(traffic, cfg["x_nominal"], seed)


@pytest.mark.parametrize("traffic", ["fleet_warm_b4096",
                                     "sample_cold_b4096"])
def test_seeded_traffic_repeats_exactly(traffic):
    seed = 2 ** 31 + 977        # beyond 32 signed bits, as the driver's
    runs = []
    for _ in range(2):
        st = _stream(traffic, "cstr_robust_n20_f32", seed)
        first = st.fleet() if st.move else st.shuffled()
        runs.append([first] + [st.period() if st.move else st.shuffled()
                               for _ in range(3)])
    for a, b in zip(*runs):
        assert np.array_equal(a, b)
    other = _stream(traffic, "cstr_robust_n20_f32", seed + 1)
    assert not np.array_equal(runs[0][0], other.fleet())


def _bench_py_draw(B, seed):
    """The JAX package's bench.py draw: 2 % spread around the nominal
    state, clipped, written out here."""
    x0 = np.array([0.8, 0.5, 134.14, 130.0])
    rng = np.random.default_rng(seed)
    return np.clip(x0 * (1.0 + 0.02 * rng.standard_normal((B, 4))),
                   [0.15, 0.15, 55, 55], [1.9, 1.9, 139.5, 139.5])


def test_cstr_pool_is_bench_py_draw_in_a_seeded_order():
    """Every run of either cell serves bench.py's fleet (its seed 0; the
    first 1024 plants are bench.py's own B = 1024), in orders the run's
    seed draws: the warm fleet once, the cold sample every call."""
    fleet = _bench_py_draw(4096, 0)
    assert np.array_equal(fleet[:1024], _bench_py_draw(1024, 0))
    key = (lambda x: x[np.lexsort(x.T)])
    a = _stream("fleet_warm_b4096", "cstr_robust_n20_f32", 7).fleet()
    b = _stream("fleet_warm_b4096", "cstr_robust_n20_f32", 8).fleet()
    assert np.array_equal(key(a), key(fleet))
    assert np.array_equal(key(b), key(fleet))
    assert not np.array_equal(a, b)
    cold = _stream("sample_cold_b4096", "cstr_robust_n20_f32", 7)
    c1, c2 = cold.shuffled(), cold.shuffled()
    assert np.array_equal(key(c1), key(fleet))
    assert np.array_equal(key(c2), key(fleet))
    assert not np.array_equal(c1, c2)


def test_band_work_reproduces_the_kernel_table_bound():
    """PERF.md's table: bound_ms at batch 128, (1152, 21, 13, 12) f32 is
    0.0232 ms, set there by the bytes."""
    assert band_bound_s(1152, 21, 13, 12, 4) * 1e3 == pytest.approx(
        0.0232, abs=5e-5)
    nbytes, flops = band_work(1152, 21, 13, 12, 4)
    assert nbytes / 3.35e12 > flops / 67e12


def test_benchmark_files_are_found_by_name():
    for c in BENCH["configs"]:
        cfg = registry.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("portbench/")
        assert (ROOT / "portbench" / "reference"
                / f"{cfg['reference']}.py").is_file()
    for w in BENCH["workloads"]:
        cell = registry.Cell(BENCH, w["name"])
        assert set(cell.limits) == {"kkt_err_max", "feas_max",
                                    "u0_gap_max", "uncertified_share"}
        mode = registry.mode(cell.traffic["mode"])
        assert all(callable(getattr(mode, f))
                   for f in ("setup", "states", "call"))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("dompc_tpu_torch", "dompc_tpu", "jax",
                                    "jaxlib", "flax"), (path, name)


def test_harness_and_reference_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.harness.bench, portbench.harness.check\n"
        "import portbench.harness.trace, portbench.harness.program\n"
        "import portbench.reference.ocp, portbench.reference.kkt\n"
        "import portbench.reference.cstr, portbench.reference.poly\n"
        "from portbench.harness import registry\n"
        "for m in %r: registry.reader(m)\n"
        "import json\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
        % (str(ROOT), [m["name"] for m in BENCH["end_to_end"]
                       + BENCH["per_layer"]]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "dompc_tpu"}
    assert "portbench" in tops
