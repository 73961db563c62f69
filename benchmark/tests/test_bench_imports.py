"""Nothing the harness or the reference loads is the JAX stack or the JAX
package (top-level names compared whole), and the reference loads nothing
of the engine under test."""

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "foundationpose_tpu"}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         capture_output=True, text=True, cwd=ROOT, check=True,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([BENCH, ROOT])})
    return {m.split(".")[0] for m in out.stdout.split()}


def test_harness_loads_no_jax():
    mods = _loaded("import run, readings\n"
                   "from fpbench import cell, faults, judge, pose, scene, spans, trace, traffic\n"
                   "import counts.nets, counts.k1\n"
                   "for w in cell.load_json(cell.BENCH_DIR, '..', 'BENCHMARK.json')['workloads']:\n"
                   "    c = cell.Cell(run.BENCH_DIR, w['name'])\n"
                   "    [c.reader(m['name']) for m in c.per_layer]\n"
                   "    [c.e2e_reader(m['name']) for m in c.end_to_end]\n"
                   "    cell.load_module(c.bench_dir, 'controls', c.config['control'])\n"
                   "import foundationpose_tpu_torch.apps.demo_synthetic")
    assert not mods & FORBIDDEN
    assert "foundationpose_tpu_torch" in mods  # the check sees the engine's name


def test_reference_loads_nothing_of_the_engine():
    mods = _loaded("import reference, reference.pose, reference.nets, reference.raster, "
                   "reference.image, reference.geometry")
    assert not mods & (FORBIDDEN | {"foundationpose_tpu_torch", "fpbench"})


def test_run_refuses_a_loaded_jax_stack(monkeypatch):
    sys.path.insert(0, BENCH)
    import run

    monkeypatch.setitem(sys.modules, "foundationpose_tpu.core", object())
    assert run.forbidden_modules() == ["foundationpose_tpu"]
    monkeypatch.delitem(sys.modules, "foundationpose_tpu.core")
    monkeypatch.setitem(sys.modules, "foundationpose_tpu_torch_x", object())
    assert "foundationpose_tpu" not in run.forbidden_modules()
