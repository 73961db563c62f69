"""The counters against hand counts."""

import pytest
import torch

from counts import k1, nets
from fpbench.peaks import H100

NET = {"c_in": 6, "encoder": [64, 128, 256, 512], "d_model": 512, "ff": 512, "rot_out": 3}


def test_conv_by_hand():
    # 160 px, 7x7 stride 2, 6 -> 64: 80 x 80 outputs, 49 x 6 multiply-adds each
    assert nets.conv(160, 160, 6, 64, 7, 2) == (2 * 80 * 80 * 64 * 49 * 6, 80, 80)
    assert nets.conv_out(32, 3, 2) == 16 and nets.conv_out(33, 3, 2) == 17


def test_refinenet_by_hand():
    conv = lambda hw, cin, cout, k: 2 * hw * hw * cout * k * k * cin  # noqa: E731
    enc_a = conv(80, 6, 64, 7) + conv(40, 64, 128, 3) + 4 * conv(40, 128, 128, 3)
    enc_ab = 4 * conv(40, 256, 256, 3) + conv(20, 256, 512, 3) + 4 * conv(20, 512, 512, 3)
    n, d = 400, 512
    layer = (2 * n * d * 3 * d) + 2 * (2 * n * n * d) + 2 * n * d * d + 2 * (2 * n * d * 512)
    by_hand = 2 * enc_a + enc_ab + 2 * layer + 2 * n * d * 3 * 2
    assert nets.refinenet(1, 160, 160, NET) == by_hand
    assert by_hand / 1e9 == pytest.approx(23.946, abs=1e-3)
    assert nets.refinenet(7, 160, 160, NET) == 7 * by_hand


def test_scorenet_by_hand():
    enc, n = nets.encoder(160, 160, NET)
    assert n == 400
    d, L = 512, 252
    att = lambda m: 2 * m * d * 3 * d + 4 * m * m * d + 2 * m * d * d  # noqa: E731
    assert nets.scorenet(L, 160, 160, NET) == L * (enc + att(400)) + att(L) + 2 * L * d


def _one_face_mesh():
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0], [0.0, 0.01, 0.0]])
    return {"pos": pos, "faces": torch.tensor([[0, 1, 2]], dtype=torch.int32),
            "vnormals": torch.zeros(3, 3), "vertex_color": torch.zeros(3, 3)}


def test_k1_pairs_and_bytes_by_hand():
    mesh = _one_face_mesh()
    pose = torch.eye(4)[None]
    pose[0, 2, 3] = 1.0  # 1 m in front: the 1 cm legs span 6 px at f = 600
    K = torch.tensor([[600.0, 0, 20], [0, 600.0, 20], [0, 0, 1]])
    tfs = torch.eye(3)[None]
    assert k1.pair_count(mesh, pose, K, tfs, (40, 40), False) == pytest.approx(18.0)
    # moved out of the crop it counts nothing
    assert k1.pair_count(mesh, pose, K, tfs + torch.tensor([[0, 0, -30.0], [0, 0, 0], [0, 0, 0]]),
                         (40, 40), False) == 0.0
    call = {"mesh": mesh, "poses": pose, "K": K, "tfs": tfs, "hw": (40, 40), "cull": False,
            "with_normal": True}
    t, nbytes, ops = k1.bound(call, H100)
    read = 3 * 12 + 3 * 12 + 12 + 64 + 36 + 36 + 3 * 12
    assert nbytes == read + 40 * 40 * (12 + 12 + 4 + 1 + 12)
    assert ops == 3 * 40 + 220 + 21 * 18.0
    assert t == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))
