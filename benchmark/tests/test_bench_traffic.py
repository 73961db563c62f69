"""The traffic kinds' generators repeat for a seed, and a seed changes the
order and poses but not the amount of work."""

import numpy as np
import pytest

import tiny
from fpbench import cell as cell_mod, scene, traffic

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def _frames(tree, name, seed):
    c = cell_mod.Cell(tree, name)
    inputs = c.kind.make_inputs(seed, c.config, c.traffic, "cpu")
    return inputs.obj, inputs.frames


@pytest.mark.parametrize("name", ["learned.register", "learned.track"])
def test_same_seed_same_frames(tree, name):
    o1, a = _frames(tree, name, SEED)
    o2, b = _frames(tree, name, SEED)
    for k in o1:
        np.testing.assert_array_equal(o1[k], o2[k])
    for x, y in zip(a.rgb + a.depth + a.mask + a.gt, b.rgb + b.depth + b.mask + b.gt):
        np.testing.assert_array_equal(x, y)
    _, c = _frames(tree, name, SEED + 1)
    assert any(not np.array_equal(x, y) for x, y in zip(a.depth, c.depth))


def test_register_distances_are_the_same_set(tree):
    dists = []
    for seed in (SEED, SEED + 1):
        _, f = _frames(tree, "learned.register", seed)
        dists.append(sorted(np.linalg.norm(p[:3, 3]) for p in f.gt))
    np.testing.assert_allclose(dists[0], dists[1], atol=0.04)


def test_object_keeps_its_sizes():
    c = cell_mod.Cell(tiny.BENCH, "learned.register")
    obj = scene.make_object(SEED, c.config["object"], "cpu")
    from reference.pose import diameter

    assert obj["faces"].shape == (4096, 3)
    assert obj["texture"].shape == (512, 512, 3)
    assert diameter(obj["vertices"]) == pytest.approx(0.2)


def test_pingpong():
    n = 4
    assert [traffic.pool_index(i, n, True) for i in range(9)] == [0, 1, 2, 3, 2, 1, 0, 1, 2]
    assert [traffic.pool_index(i, n, False) for i in range(6)] == [0, 1, 2, 3, 0, 1]
