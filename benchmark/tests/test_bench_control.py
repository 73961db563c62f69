"""What decides ``correct`` fails when it should: the lower-precision
control in the engine's place, and the engine broken underneath (a refine
step that returns its poses unchanged, half of the hypotheses left out, an
answer altered where it is produced). Driven on the CPU at the small size
of ``tiny.py``, through the whole run but the look for a card."""

import sys

import pytest
import torch

import tiny
from fpbench import cell as cell_mod, faults

SEED = 2**31 + 101
CELLS = ["learned.register", "geometric.register", "learned.track"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def _run(tree, name, keep=None, device="cpu"):
    c = cell_mod.Cell(tree, name)
    return c, cell_mod.run(c, SEED, 0.3, False, device, 0.0, keep=keep)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tree, name):
    _, r = _run(tree, name)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"
    assert not {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "optax",
                                                          "foundationpose_tpu"}


@pytest.mark.parametrize("name", ["learned.register", "learned.track"])
def test_fp8_control_is_not_correct(tree, name):
    keep = {}
    c, r = _run(tree, name, keep)
    assert r["correct"] is True
    checks, _ = cell_mod.check(c, SEED, keep["state"], "cpu", sys.stderr, control=True)
    assert any(v["value"] > v["limit"] for v in checks.values()), checks


@pytest.mark.parametrize("name,fault", [
    ("learned.register", "unchanged"), ("learned.register", "half"),
    ("learned.register", "answer"), ("geometric.register", "unchanged"),
    ("geometric.register", "answer"), ("learned.track", "unchanged"),
    ("learned.track", "half"), ("learned.track", "answer")])
def test_fault_is_not_correct(tree, name, fault):
    with faults.planted(fault):
        _, r = _run(tree, name)
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
def test_tf32_control_is_not_correct_on_the_card(tree):
    """TF32 exists on the card only: the geometric cell's control there."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 is a CUDA feature: no card here")
    keep = {}
    c, _ = _run(tree, "geometric.register", keep, "cuda")
    checks, _ = cell_mod.check(c, SEED, keep["state"], "cuda", sys.stderr, control=True)
    assert any(v["value"] > v["limit"] for v in checks.values()), checks
