"""Name-level surface audit of the port against the JAX package.

Both packages are parsed with ``ast``; neither is imported, so this file
needs no JAX. For every module of ``foundationpose_tpu/`` that has a
counterpart in ``foundationpose_tpu_torch/`` (same relative path), each of
these must exist in the counterpart, or be named in ``RENAMED`` (JAX name ->
port name) or ``JAX_ONLY`` (no meaning in the port), each entry with its
reason:

- every public top-level function and class (``mod::name``);
- every public method of a public class and every dataclass field
  (``mod::Class.name``; a field of a flax module is a field too);
- every parameter of a public function or method and of a public class's
  constructor (``mod::fn(p)``, ``mod::Class.method(p)``, ``mod::Class(p)``);
- every ``argparse`` option of an ``apps/`` module (``mod::--option``).

In the port a class member is found among its methods, properties, annotated
fields, constructor parameters and ``self.<name>`` attributes; a top-level
name among its definitions, assignments and imports. A name under a
``JAX_ONLY`` entry is not looked at; a name under a ``RENAMED`` entry is
looked for under the new name.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "foundationpose_tpu")
PORT_PKG = os.path.join(ROOT, "foundationpose_tpu_torch")


# ---------------------------------------------------------------- the audit

def _is_public(name):
    return not name.startswith("_")


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _is_setter(fn):
    return any(isinstance(d, ast.Attribute) and d.attr in ("setter", "deleter")
               for d in fn.decorator_list)


def _options(tree):
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and a.value.startswith("-")}
    return out


def jax_surface(src, mod):
    """Keys of what the JAX module ``mod`` offers (see the module docstring)."""
    tree = ast.parse(src)
    keys = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _is_public(node.name):
            keys.add(f"{mod}::{node.name}")
            keys |= {f"{mod}::{node.name}({p})" for p in _params(node)}
        elif isinstance(node, ast.ClassDef) and _is_public(node.name):
            cls = f"{mod}::{node.name}"
            keys.add(cls)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name == "__init__":
                        keys |= {f"{cls}({p})" for p in _params(sub)}
                    elif _is_public(sub.name) and not _is_setter(sub):
                        keys.add(f"{cls}.{sub.name}")
                        keys |= {f"{cls}.{sub.name}({p})" for p in _params(sub)}
                elif (isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name)
                      and _is_public(sub.target.id)):
                    keys.add(f"{cls}.{sub.target.id}")
    if mod.startswith("apps/"):
        keys |= {f"{mod}::{o}" for o in _options(tree)}
    return keys


def port_surface(src, mod):
    """Keys of what the port's module ``mod`` offers, read leniently: a class
    member may be a method, property, field, constructor parameter or
    ``self`` attribute; a top-level name may be defined, assigned or
    imported."""
    tree = ast.parse(src)
    keys = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            keys.add(f"{mod}::{node.name}")
            keys |= {f"{mod}::{node.name}({p})" for p in _params(node)}
        elif isinstance(node, ast.ClassDef):
            cls = f"{mod}::{node.name}"
            keys.add(cls)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name == "__init__":
                        keys |= {f"{cls}({p})" for p in _params(sub)}
                        keys |= {f"{cls}.{p}" for p in _params(sub)}
                    keys.add(f"{cls}.{sub.name}")
                    keys |= {f"{cls}.{sub.name}({p})" for p in _params(sub)}
                    for n in ast.walk(sub):
                        if (isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
                                and isinstance(n.value, ast.Name) and n.value.id == "self"):
                            keys.add(f"{cls}.{n.attr}")
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    keys |= {f"{cls}.{sub.target.id}", f"{cls}({sub.target.id})"}
                elif isinstance(sub, ast.Assign):
                    keys |= {f"{cls}.{t.id}" for t in sub.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            keys |= {f"{mod}::{t.id}" for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            keys |= {f"{mod}::{(a.asname or a.name).split('.')[0]}" for a in node.names}
    if mod.startswith("apps/"):
        keys |= {f"{mod}::{o}" for o in _options(tree)}
    return keys


def parent(key):
    mod, path = key.split("::")
    if path.endswith(")"):
        return f"{mod}::{path[:path.index('(')]}"
    if "." in path and not path.startswith("-"):
        return f"{mod}::{path.rsplit('.', 1)[0]}"
    return None


def translate(key, renamed):
    """The port key a JAX key is looked for under."""
    if key in renamed:
        return renamed[key]
    up = parent(key)
    if up is None:
        return key
    return translate(up, renamed) + key[len(up):]


def _covered(key, table):
    while key is not None:
        if key in table:
            return True
        key = parent(key)
    return False


def audit(jax_keys, port_keys, renamed, jax_only):
    """JAX keys the port lacks: neither found (under their port name) nor
    under a ``JAX_ONLY`` entry. A key whose parent is missing is not listed
    again."""
    missing, absent = set(), set()  # absent: missing, or under a missing key
    for key in sorted(jax_keys, key=len):
        if _covered(key, jax_only):
            continue
        if parent(key) in absent:
            absent.add(key)
        elif translate(key, renamed) not in port_keys:
            missing.add(key)
            absent.add(key)
    return sorted(missing)


def _modules(pkg):
    out = {}
    for d, _, names in os.walk(pkg):
        if "_build" in d or "__pycache__" in d:
            continue
        for n in names:
            if n.endswith(".py"):
                out[os.path.relpath(os.path.join(d, n), pkg)] = os.path.join(d, n)
    return out


def _read(path):
    with open(path) as f:
        return f.read()


def package_surfaces():
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    jax_keys, port_keys = set(), set()
    for mod, path in jax_mods.items():
        if mod in port_mods:
            jax_keys |= jax_surface(_read(path), mod)
            port_keys |= port_surface(_read(port_mods[mod]), mod)
    return jax_keys, port_keys


# ---------------------------------------------------------------- the tables

ENGINE = "the engine class is named after its framework"
EAGER = "the eager call the JAX package wraps in a jit program"
NET = "an ``nn.Module`` holds its parameters: the net is passed, not a parameter tree"
OPT = "the port's ``Optimizer`` holds optax's transformation and its state"

RENAMED = {  # JAX key -> (port key, reason)
    "engine/estimator.py::FoundationPoseTPU": ("engine/estimator.py::FoundationPoseTorch", ENGINE),
    "field/runner.py::NeRFRunnerTPU": ("field/runner.py::NeRFRunner", ENGINE),
    "engine/refiner.py::PoseRefiner.predict": ("engine/refiner.py::PoseRefiner.refine", EAGER),
    "engine/geometric.py::GeometricRefiner.predict": (
        "engine/geometric.py::GeometricRefiner.refine", EAGER),
    "engine/scorer.py::PoseScorer.predict": ("engine/scorer.py::PoseScorer.score", EAGER),
    "engine/scorer.py::HybridScorer.predict": ("engine/scorer.py::HybridScorer.score", EAGER),
    "engine/geometric.py::GeometricScorer.predict": (
        "engine/geometric.py::GeometricScorer.score", EAGER),
    "core/geometry.py::normalize(axis)": ("core/geometry.py::normalize(dim)",
                                          "torch's name for the axis"),
    "models/training.py::make_refiner_train_state(rng)": (
        "models/training.py::make_refiner_train_state(seed)",
        "an int seeds ``flax_init``'s ``torch.Generator``; there is no JAX key"),
    "models/weights.py::load_engine_params(weights_dir)": (
        "models/weights.py::load_engine_params(weights)",
        "a directory, or an engine checkpoint file of the port"),
    "models/agnostic.py::save_agnostic(params_r)": ("models/agnostic.py::save_agnostic(net_r)", NET),
    "models/agnostic.py::save_agnostic(params_s)": ("models/agnostic.py::save_agnostic(net_s)", NET),
    "models/agnostic.py::save_params_npz(params)": ("models/agnostic.py::save_params_npz(net)", NET),
    "models/agnostic.py::load_params_npz(target)": ("models/agnostic.py::load_params_npz(net)", NET),
    **{f"models/training.py::{fn}(tx)": (f"models/training.py::{fn}(opt)", OPT)
       for fn in ("refiner_train_step", "refiner_train_step_multimesh", "scorer_train_step")},
}

FUSED = "fused-program protocol of the XLA estimator: the port runs each stage eagerly"
USE_PALLAS = "``use_pallas``: the port picks the kernel by the tensor's device, with no switch"
KEY = ("``key``: draws are split from the arithmetic; the caller passes the draws or a "
       "``torch.Generator``")
COUNT = ("the sample count is the shape of the uniforms the caller draws (draws are split "
         "from the arithmetic)")
PARAMS = "``params``: an ``nn.Module`` holds its parameters"
OPT_STATE = "``opt_state``: the port's ``Optimizer`` holds its state"
DTYPE = ("``dtype``: the port's layers cast their weights to the input's dtype at use; the "
         "net's ``dtype`` picks it")
SETUP = "flax's ``setup``: an ``nn.Module`` builds its layers in ``__init__``"
UNUSED = "unused in the JAX package"

JAX_ONLY = {  # JAX key -> why the name has no meaning in the port
    **{k: USE_PALLAS for k in (
        "engine/crop.py::make_crop_batch(use_pallas)",
        "engine/geometric.py::GeometricConfig.use_pallas",
        "engine/refiner.py::RefinerConfig.use_pallas",
        "engine/scorer.py::ScorerConfig.use_pallas",
        "models/agnostic.py::train_agnostic_refiner(use_pallas)",
        "models/agnostic.py::train_agnostic_scorer(use_pallas)",
        "models/datagen.py::make_refine_batch(use_pallas)",
        "models/datagen.py::make_score_batch(use_pallas)")},
    **{f"engine/{mod}::{cls}.{name}": FUSED
       for mod, cls, names in (
           ("refiner.py", "PoseRefiner", ("traced_refine",)),
           ("geometric.py", "GeometricRefiner", ("traced_refine",)),
           ("scorer.py", "PoseScorer", ("traced_score",)),
           ("scorer.py", "HybridScorer", ()),
           ("geometric.py", "GeometricScorer", ("traced_score",)))
       for name in ("program_key", "program_params", "traced_body_fn") + names},
    **{k: PARAMS for k in (
        "engine/refiner.py::PoseRefiner(params)",
        "engine/refiner.py::refine_once(params)",
        "engine/scorer.py::PoseScorer(params)",
        "engine/scorer.py::HybridScorer.params",
        "models/training.py::refiner_loss(params)",
        "models/training.py::scorer_loss(params)",
        "models/training.py::refiner_train_step(params)",
        "models/training.py::refiner_train_step_multimesh(params)",
        "models/training.py::scorer_train_step(params)")},
    **{k: OPT_STATE for k in (
        "models/training.py::refiner_train_step(opt_state)",
        "models/training.py::refiner_train_step_multimesh(opt_state)",
        "models/training.py::scorer_train_step(opt_state)")},
    **{k: KEY for k in (
        "field/sampling.py::stratified_samples(key)",
        "field/sampling.py::sample_pdf(key)",
        "field/sampling.py::sample_rays(key)",
        "models/datagen.py::make_refine_batch(key)",
        "models/datagen.py::make_score_batch(key)")},
    **{k: COUNT for k in (
        "field/sampling.py::stratified_samples(n_samples)",
        "field/sampling.py::sample_rays(n_uniform)",
        "field/sampling.py::sample_rays(n_around_depth)")},
    **{k: DTYPE for k in (
        "models/layers.py::ConvNormAct.dtype",
        "models/layers.py::ResnetBasicBlock.dtype",
        "models/layers.py::MultiheadSelfAttention.dtype",
        "models/layers.py::TransformerEncoderLayer.dtype",
        "models/refine_net.py::EncoderA.dtype",
        "models/refine_net.py::EncoderAB.dtype")},
    **{k: SETUP for k in (
        "field/nerf.py::NeRFSmall.setup",
        "field/nerf.py::ObjectField.setup",
        "ops/hashgrid.py::HashGridEncoder.setup")},
    **{k: UNUSED + ": every caller keeps the default ``True``" for k in (
        "models/layers.py::ConvNormAct.use_bias",
        "models/layers.py::ResnetBasicBlock.use_bias")},
    "field/sampling.py::sample_rays(near_far)": UNUSED,
    "field/texture.py::bake_texture(depth_tol)": UNUSED,
    "core/meshio.py::save_ply(ascii)": UNUSED + ": it always writes ASCII",
    "ops/image.py::warp_crop_affine(compute_dtype)": (
        "the TPU path's bf16 weight matmuls; the port warps in float32, which the card's "
        "memory affords"),
    "core/metrics.py::adds_err(chunk)": (
        "the chunk of a brute-force nearest-neighbour search; the port uses a KD-tree"),
    "utils/vis.py::make_comparison_strip(scores)": (
        "cv2 text on the canvas; the port draws without cv2, which the card's machine lacks"),
}


def test_port_has_every_name_of_the_jax_package():
    jax_keys, port_keys = package_surfaces()
    renamed = {k: v[0] for k, v in RENAMED.items()}
    missing = audit(jax_keys, port_keys, renamed, JAX_ONLY)
    assert not missing, "\n".join(missing)


def test_the_audit_reads_every_module_with_a_counterpart():
    """Not vacuous: every JAX module except the Pallas rasterizer and XLA's
    compile cache (``test_torch_imports.py``) is parsed, and each kind of
    key is found."""
    jax_mods, port_mods = _modules(JAX_PKG), _modules(PORT_PKG)
    assert set(jax_mods) - set(port_mods) == {"ops/raster_pallas.py", "utils/jaxcache.py"}
    jax_keys, _ = package_surfaces()
    assert len(jax_keys) > 1000
    for probe in ("core/geometry.py::to_homo", "engine/estimator.py::FoundationPoseTPU.register",
                  "engine/estimator.py::EstimatorConfig.track_hypotheses",
                  "models/agnostic.py::train_agnostic_scorer(dtype)",
                  "apps/demo_synthetic.py::--out-dir"):
        assert probe in jax_keys, probe


@pytest.mark.parametrize("table", ["RENAMED", "JAX_ONLY"])
def test_every_table_entry_names_something_of_the_jax_package(table):
    """The tables cannot go stale: each entry names a key the JAX package
    has and carries a reason; a rename's target exists in the port."""
    jax_keys, port_keys = package_surfaces()
    entries = RENAMED if table == "RENAMED" else JAX_ONLY
    for key, value in entries.items():
        assert key in jax_keys, f"{table}: {key} is not in the JAX package"
        reason = value[1] if table == "RENAMED" else value
        assert isinstance(reason, str) and len(reason) > 10, key
        if table == "RENAMED":
            assert value[0] in port_keys, f"{key} -> {value[0]}: not in the port"
    assert not set(RENAMED) & set(JAX_ONLY)


JAX_SRC = '''
import argparse
from dataclasses import dataclass

@dataclass
class Config:
    size: int = 160
    use_pallas: bool = None

class Engine:
    def __init__(self, mesh, params=None):
        pass
    def predict(self, poses, key):
        pass
    def _private(self):
        pass

def helper(x, chunk=8):
    pass

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir")
    p.add_argument("--cpu", action="store_true")
'''

PORT_SRC = '''
import argparse
import dataclasses

@dataclasses.dataclass
class Config:
    size: int = 160

class EngineTorch:
    def __init__(self, mesh, device=None):
        self.device = device
    def refine(self, poses, gen):
        pass

def helper(x):
    pass

def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir")
'''

TOY_RENAMED = {"apps/toy.py::Engine": "apps/toy.py::EngineTorch",
               "apps/toy.py::Engine.predict": "apps/toy.py::EngineTorch.refine"}
TOY_JAX_ONLY = {"apps/toy.py::Config.use_pallas": USE_PALLAS,
                "apps/toy.py::Engine(params)": PARAMS,
                "apps/toy.py::Engine.predict(key)": KEY,
                "apps/toy.py::helper(chunk)": "a chunk size the port has no use for",
                "apps/toy.py::--cpu": "an option the port spells otherwise"}


@pytest.mark.parametrize("drop", [None, *TOY_RENAMED, *TOY_JAX_ONLY])
def test_audit_fails_on_a_missing_name(drop):
    """Two small module sources: the audit passes with the full tables and
    names exactly the key whose entry is dropped; a dropped rename reports
    the class or method, not its members."""
    jax_keys = jax_surface(JAX_SRC, "apps/toy.py")
    port_keys = port_surface(PORT_SRC, "apps/toy.py")
    assert "apps/toy.py::Engine._private" not in jax_keys
    renamed = {k: v for k, v in TOY_RENAMED.items() if k != drop}
    jax_only = {k: v for k, v in TOY_JAX_ONLY.items() if k != drop}
    assert audit(jax_keys, port_keys, renamed, jax_only) == ([] if drop is None else [drop])


def test_audit_names_a_field_a_method_and_an_option_the_port_lacks():
    port = (PORT_SRC.replace("    size: int = 160\n", "    other: int = 1\n")
            .replace('    p.add_argument("--out-dir")\n', "")
            .replace("    def refine(self, poses, gen):\n        pass\n", "    pass\n"))
    missing = audit(jax_surface(JAX_SRC, "apps/toy.py"), port_surface(port, "apps/toy.py"),
                    TOY_RENAMED, TOY_JAX_ONLY)
    assert missing == ["apps/toy.py::--out-dir", "apps/toy.py::Config.size",
                       "apps/toy.py::Engine.predict"]
