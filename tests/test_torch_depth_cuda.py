"""The depth preprocess's dispatcher (``ops/depth_cuda.py``) and what surrounds
its CUDA kernel K2 (``csrc/depth_preprocess.cu``).

K2 runs only on a card, where ``chip_smoke.py`` holds it against the plain
composition bit for bit. Here: a CPU tensor takes the plain composition
(``erode_depth`` -> ``bilateral_filter_depth`` -> ``depth2xyzmap``) bit for
bit and launches nothing; that composition agrees with the JAX package's
within 1e-6 (same shift stack and order, float32); ``preprocess_depth``'s
row-sharded branch gives the unsharded result bit for bit; every card
library is one row of ``ops/kernels.py``'s table, built together, and each
kernel's binding (K1s's and K1r's too) takes its C signature's argument
types; the constants compiled into the kernel are the plain functions'
defaults; K2's bound counts each pixel once; the smoke's launch counts carry
K2 beside K1s and K1r, per path, and hold it at one launch per frame
preprocessed.
"""

import ctypes
import importlib.util
import inspect
import os
import re
import threading
import types

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo
from foundationpose_tpu.ops import image as jimops
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.engine import estimator
from foundationpose_tpu_torch import native
from foundationpose_tpu_torch.ops import depth_cuda, kernels
from foundationpose_tpu_torch.ops import image as imops
from foundationpose_tpu_torch.ops import raster_bounds
from foundationpose_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)
K = np.array([[420.0, 0, 61.5], [0, 410.0, 50.25], [0, 0, 1]], np.float32)
HALO_ROWS = (28, 60)  # a row block of the noisy frame, with its 4-row halo


def _noisy_depth(seed=0, hw=(96, 128)):
    """Noisy depth with holes, a step edge, a hole block and out-of-range
    pixels (beyond zfar, negative)."""
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    depth = 0.6 + 0.002 * xx + 0.001 * yy + rng.normal(0, 0.0015, hw)
    depth[20:50, 30:70] -= 0.15
    depth[rng.uniform(size=hw) < 0.08] = 0.0
    depth[60:70, 90:100] = 0.0
    depth[5, 5] = 150.0
    depth[40, 7] = -0.3
    return depth.astype(np.float32)


CASES = {
    "noisy_holes_step": lambda: _noisy_depth(0),
    "frame_224": lambda: _noisy_depth(1, (224, 224)),
    "all_zero": lambda: np.zeros((40, 56), np.float32),
    "halo_row_block": lambda: np.ascontiguousarray(_noisy_depth(2)[slice(*HALO_ROWS)]),
}


def _composition(d, K_):
    f = imops.bilateral_filter_depth(imops.erode_depth(d, radius=2), radius=2)
    return f, geo.depth2xyzmap(f, K_)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_dispatch_is_the_plain_composition(case):
    d = torch.from_numpy(CASES[case]())
    K_t = torch.from_numpy(K)
    before = dict(kernels.LAUNCHES)
    out, xyz = depth_cuda.preprocess(d, K_t)
    ref, ref_xyz = _composition(d, K_t)
    assert torch.equal(out, ref) and torch.equal(xyz, ref_xyz)
    only, none = depth_cuda.preprocess(d)
    assert torch.equal(only, ref) and none is None
    assert kernels.LAUNCHES == before  # no kernel launch on the CPU
    if case != "all_zero":
        assert (imops.erode_depth(d) == 0).sum() > (d == 0).sum()  # it erodes something
        assert ((ref != d) & (d > 0)).any()  # and smooths something
    else:
        assert not ref.any() and not xyz.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_composition_matches_the_jax_package(case):
    d = CASES[case]()
    out, xyz = depth_cuda.preprocess(torch.from_numpy(d), torch.from_numpy(K))
    ref = jimops.bilateral_filter_depth(jimops.erode_depth(d, radius=2), radius=2)
    ref_xyz = jgeo.depth2xyzmap(ref, K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(ref_xyz), rtol=0, atol=1e-6)
    assert ((out.numpy() == 0) == (np.asarray(ref) == 0)).all()


def _emulated_all_sum(world):
    """``all_sum`` over ``world`` threads, each one process of the mesh."""
    bufs, barrier = {}, threading.Barrier(world)

    def all_sum(mesh, x, axis="batch"):
        bufs[mesh.index(axis)] = x
        barrier.wait()
        out = sum(bufs[i] for i in range(world))  # adding zeros is exact
        barrier.wait()
        return out
    return all_sum


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_preprocess_equals_unsharded(monkeypatch, world):
    """``preprocess_depth`` with a row-sharded mesh (each process filters
    its rows with a 4-row halo, the rows are gathered) gives the unsharded
    result bit for bit; the processes run as threads with an emulated
    all_reduce."""
    d = torch.from_numpy(_noisy_depth(3))
    K_t = torch.from_numpy(K)
    monkeypatch.setattr(mesh_mod, "all_sum", _emulated_all_sum(world))
    got, errors = {}, []

    def rank(i):
        try:
            m = mesh_mod.Mesh(("batch",), (world,), (i,), torch.device("cpu"))
            got[i] = estimator.preprocess_depth(d, K_t, m)
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    ref, ref_xyz = estimator.preprocess_depth(d, K_t)
    assert torch.equal(ref, _composition(d, K_t)[0])
    for i in range(world):
        assert torch.equal(got[i][0], ref) and torch.equal(got[i][1], ref_xyz)


def _c_signature(source, name):
    with open(source) as f:
        src = f.read()
    m = re.search(r'extern "C"\s+(\w+)\s+' + name + r"\s*\(([^)]*)\)", src)
    assert m, f"no extern \"C\" {name} in {source}"
    params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
    return m.group(1), params


@pytest.mark.parametrize("name", list(kernels.LIBRARIES))
def test_binding_argtypes_match_the_c_signature(monkeypatch, name):
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    entry = kernels.LIBRARIES[name].entry
    ret, params = _c_signature(kernels.LIBRARIES[name].source, entry)
    lib = types.SimpleNamespace(**{entry: types.SimpleNamespace()})
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: lib)
    fn = kernels.load(name, f"libfp_{name.lower()}.so")
    assert fn.argtypes == [ctype[p] for p in params]
    assert fn.restype is ctype[ret]


def test_compiled_constants_are_the_plain_defaults():
    """The thresholds and radius compiled into K2 are the defaults of the
    plain functions it is held against (and ``depth_cuda.RADIUS``)."""
    with open(kernels.LIBRARIES["K2"].source) as f:
        defs = dict(re.findall(r"^#define (\w+) ([-\w.]+)", f.read(), re.M))
    num = {k: float(v.rstrip("f")) for k, v in defs.items() if re.fullmatch(r"[-\d.e]+f?", v)}
    erode = inspect.signature(imops.erode_depth).parameters
    bilat = inspect.signature(imops.bilateral_filter_depth).parameters
    assert num["R"] == depth_cuda.RADIUS == 2
    assert num["ZFAR"] == erode["zfar"].default == bilat["zfar"].default
    assert num["DIFF_THRES"] == erode["depth_diff_thres"].default
    assert num["RATIO_THRES"] == erode["ratio_thres"].default
    assert num["SIGMA_D"] == bilat["sigma_d"].default
    assert num["SIGMA_R"] == bilat["sigma_r"].default
    assert defs["XYZ_ZFAR"] == "INFINITY" and inspect.signature(
        geo.depth2xyzmap).parameters["zfar"].default == float("inf")


def test_every_card_library_is_built_from_one_table(monkeypatch):
    """K1s, K1r and K2 are the rows of ``kernels.LIBRARIES``, each source
    under ``csrc/`` with the common nvcc flags (plus ``-fmad=false`` for K1s
    and K2); the first use builds all three with one ``compile_libraries``
    call, through nvcc, into ``BUILD_LOG``, and loads them all."""
    assert set(kernels.LIBRARIES) == {"K1s", "K1r", "K2"}
    files = {"K1s": "raster_setup.cu", "K1r": "raster.cu", "K2": "depth_preprocess.cu"}
    for name, lib in kernels.LIBRARIES.items():
        assert lib.source.endswith(os.path.join("csrc", files[name]))
        assert kernels.spec(name) == (lib.source, kernels.NVCC_FLAGS + list(lib.flags))
        assert ("-fmad=false" in lib.flags) == (name != "K1r")
    calls, loaded = [], []

    def compile_libraries(compiler, specs, log):
        calls.append((compiler, specs, log))
        return {name: f"lib{name}.so" for name in specs}

    monkeypatch.setattr(native, "compile_libraries", compile_libraries)
    monkeypatch.setattr(kernels, "load", lambda name, path: loaded.append((name, path)) or name)
    monkeypatch.setattr(kernels, "_paths", None)
    monkeypatch.setattr(kernels, "_fns", None)
    assert kernels.build() == {"K1s": "K1s", "K1r": "K1r", "K2": "K2"}
    assert kernels.build() is kernels.build()
    assert calls == [(kernels.nvcc(), {k: kernels.spec(k) for k in kernels.LIBRARIES},
                      kernels.BUILD_LOG)]
    assert loaded == [(k, f"lib{k}.so") for k in ("K1s", "K1r", "K2")]


def test_k2_bound_reads_and_writes_each_pixel_once():
    b = raster_bounds.k2_bound(480, 640)
    assert b["bytes"] == (4 + 4 + 12) * 480 * 640
    assert b["operations"] == raster_bounds.OPS_PER_K2_PIXEL * 480 * 640
    assert b["bound_ms"] == max(b["bound_bytes_ms"], b["bound_operations_ms"]) > 0
    assert b["bound_bytes_ms"] == pytest.approx(20 * 480 * 640 / 3.35e12 * 1e3)


def _load_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke_k2",
                                                  os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_counts_k2_per_path_and_holds_it(monkeypatch):
    """``reset_launches`` sets K2 to 0 with K1s and K1r; ``expect_launches``
    returns all three and reports a K2 count other than the one asked for."""
    smoke = _load_smoke()
    monkeypatch.setattr(kernels, "LAUNCHES", {"K1s": 7, "K1r": 7, "K2": 1014})
    smoke.reset_launches()
    assert smoke.launch_counts() == {"K1s": 0, "K1r": 0, "K2": 0}
    before = smoke.launch_counts()
    kernels.LAUNCHES.update(K1s=11, K1r=11, K2=1)
    got = smoke.expect_launches(before, 11, "register", k2=1)
    assert got == {"K1s": 11, "K1r": 11, "K2": 1} and smoke.FAILURES == []
    smoke.expect_launches(before, 11, "register", k2=2)
    assert smoke.FAILURES == ["register launched K2 1 times, expected 2"]
    with pytest.raises(SystemExit):
        smoke.expect_launches(before, 4, "track frame", k2=1)


def test_smoke_counts_the_harness_frames():
    """One preprocess per register trial and per frame of a tracked
    trajectory (its first frame is registered)."""
    smoke = _load_smoke()
    trials = {"scenes": {"a": {"adds": [0.1, 0.2]}, "b": {"adds": [0.3, 0.1]}}}
    res = {"modes": {
        "geometric": {"register": {"full": trials, "coarse": trials},
                      "track": {"scenes": {"a": {"n_frames": 11}, "b": {"n_frames": 11}}}},
        "learned": {"register": {"full": trials, "note": {}}}}}
    assert smoke.harness_frames(res) == 4 + 4 + 22 + 4
