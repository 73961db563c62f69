"""The segmenter's cell: its FLOP and least-time counts against hand counts
at ViT-H, its readers on a canned trace and canned span records, and the
``register_box`` kind at the CPU size of ``tiny.py`` with the segmenter cut to
small widths in float32: the same seed gives the same boxes and weights, a
sound run is correct, and the fp8 control fails a SAM number."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import tiny
from counts import sam
from fpbench import cell as cell_mod, program
from fpbench.peaks import H100

BENCH = cell_mod.BENCH_DIR
CELL = "learned_sam.register"
SEED = 2**31 + 23
VIT_H = cell_mod.load_json(BENCH, "configs", "fp_learned_sam_h.json")["segmenter"]
# a global block and windows of 6 on a 16 x 16 grid (padded to 18 x 18)
SMALL = {"encoder_embed_dim": 64, "encoder_depth": 3, "encoder_num_heads": 4,
         "encoder_global_attn_indexes": [1], "image_size": 256, "window_size": 6,
         "prompt_embed_dim": 32, "decoder_num_heads": 2, "decoder_mlp_dim": 64,
         "iou_head_hidden_dim": 32, "dtype": "float32"}
# engine and reference alike in float32 on the CPU: a sound run reads ~1e-6
# on the SAM numbers and 0 on the others; the limits sit above those and
# below what the fp8 control reads
LIMITS = {"sam_logit_gap_p99": 1e-3, "sam_iou_gap": 1e-4, "refine_gap_p75_mm": 0.01,
          "score_gap_median": 1e-4, "answer_gap_m": 0.0}


def test_vit_h_flops_by_hand():
    D, n, dh, hidden = 1280, 64 * 64, 80, 5120
    padded = 70 * 70  # 64 x 64 tokens padded to 5 x 5 windows of 14 x 14
    windowed = (2 * padded * D * 3 * D + 2 * padded * D * D            # qkv, proj on the pad
                + 4 * 25 * 16 * 196 * 196 * dh + 4 * 25 * 16 * 196 * 14 * dh
                + 2 * 2 * n * D * hidden)                                # MLP on the grid
    global_ = (2 * n * D * 3 * D + 2 * n * D * D + 4 * 16 * n * n * dh + 4 * 16 * n * 64 * dh
               + 2 * 2 * n * D * hidden)
    patch, neck = 2 * n * 768 * D, 2 * n * D * 256 + 2 * n * 256 * 256 * 9
    by_hand = 28 * windowed + 4 * global_ + patch + neck
    assert sam.encoder(VIT_H) == by_hand
    assert by_hand / 1e12 == pytest.approx(5.961, abs=1e-3)  # ~5.96 TFLOP a frame
    assert windowed / 1e9 == pytest.approx(176.87, abs=0.01)
    assert global_ / 1e9 == pytest.approx(248.30, abs=0.01)
    # the decoder is a rounding error beside it: ~3.6 GFLOP a box
    assert 3e9 < sam.decoder(VIT_H) < 4e9
    assert sam.flops(VIT_H, 2) == sam.encoder(VIT_H) + sam.decoder(VIT_H, 2)


def test_vit_h_attention_bounds_by_hand():
    blocks = sam.attn_blocks(VIT_H)
    assert [b[0] for b in blocks].count(True) == 4 and blocks[7] == (True, 16, 4096, 64)
    assert blocks[0] == (False, 400, 196, 14)
    t, nbytes, ops = sam.attn_bound(16, 4096, 64, 80, H100)
    assert ops == 4 * 16 * 4096 * 4096 * 80 + 4 * 16 * 4096 * 64 * 80
    assert nbytes == 2 * (4 * 16 * 4096 * 80 + 2 * 127 * 80)
    assert t == pytest.approx(ops / 989e12)  # global: bound by FLOPs
    t, nbytes, ops = sam.attn_bound(400, 196, 14, 80, H100)
    assert t == pytest.approx(nbytes / 3.35e12)  # windowed: bound by bytes


def _records(segments, boxes=1):
    """Span records of ``segments`` segmenter calls at ViT-H."""
    out = []
    for _ in range(segments):
        out.append({"name": "sam.segment", "n": boxes, "size": None})
        for is_global, batch, tokens, _ in sam.attn_blocks(VIT_H):
            out.append({"name": "sam.attn.global" if is_global else "sam.attn.window",
                        "n": batch, "size": tokens})
    return out


def _rec(**over):
    rec = {"calls": 2, "kept": {}, "peaks": H100, "wall_s_per_call": 0.3,
           "config": {"segmenter": VIT_H, "net": cell_mod.load_json(
               BENCH, "configs", "fp_learned.json")["net"]},
           "span_ms": {"sam.segment": 50.0, "sam.attn.window": 10.0, "sam.attn.global": 6.0}}
    rec.update(over)
    return rec


def _reader(metric):
    return cell_mod.Cell(BENCH, CELL).reader(metric)


def test_segmenter_readers(monkeypatch):
    from foundationpose_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "records", lambda: _records(2))
    rec = _rec()
    assert _reader("sam_ms.register_sam")(rec) == pytest.approx(25.0)
    flops = sam.flops(VIT_H)
    assert _reader("sam_mfu.register_sam")(rec) == pytest.approx(
        100 * 2 * flops / (50e-3 * 989e12))
    least = 2 * sum(sam.attn_bound(b, t, s, 80, H100)[0] for _, b, t, s in sam.attn_blocks(VIT_H))
    assert _reader("sam_attn_roofline.register_sam")(rec) == pytest.approx(100 * least / 16e-3)
    # call_mfu: the nets' FLOPs from the kept forwards plus SAM's, over wall time
    from counts import nets

    kept = {"refiner.net.forward": [(256, 160, 160, 6)], "scorer.net.forward": [(256, 160, 160, 6)]}
    net = rec["config"]["net"]
    per_call = (nets.refinenet(256, 160, 160, net) + nets.scorenet(256, 160, 160, net)
                + 2 * flops) / 2
    assert _reader("call_mfu.register_sam")(_rec(kept=kept)) == pytest.approx(
        100 * per_call / (0.3 * 989e12))
    # the register layers after the mask are read on this cell by the readers
    # of learned.register
    for q in ("launches_per_call", "nets_ms", "warp_ms", "k1_roofline", "preprocess_ms", "glue_ms",
              "wait_host_ms"):
        assert _reader(q + ".register_sam") is _reader(q + ".register")


def test_segmenter_readers_without_spans(monkeypatch):
    from foundationpose_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "records", lambda: [])
    for metric in ("sam_mfu.register_sam", "sam_attn_roofline.register_sam",
                   "call_mfu.register_sam"):
        with pytest.raises(program.NoSpans):
            _reader(metric)(_rec(kept={"refiner.net.forward": [(1, 160, 160, 6)]}))
    with pytest.raises(program.NoSpans):
        _reader("sam_ms.register_sam")(_rec(span_ms={}))
    monkeypatch.delattr(profiling, "records")  # an engine from before the spans
    for metric in ("sam_ms.register_sam", "sam_mfu.register_sam",
                   "sam_attn_roofline.register_sam", "call_mfu.register_sam"):
        assert _reader(metric)(_rec()) is None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    bench = tiny.make(str(tmp_path_factory.mktemp("bench")))
    path = os.path.join(bench, "configs", "fp_learned_sam_h.json")
    cfg = cell_mod.load_json(path)
    cfg["segmenter"].update(SMALL)
    with open(path, "w") as f:
        json.dump(cfg, f)
    path = os.path.join(bench, "traffic", "register_box16.json")
    tr = cell_mod.load_json(path)
    tr.update(tiny.TRAFFIC["register_pool16"])
    with open(path, "w") as f:
        json.dump(tr, f)
    with open(os.path.join(bench, "limits", CELL + ".json"), "w") as f:
        json.dump(LIMITS, f)
    return bench


def test_same_seed_same_boxes(tree):
    c = cell_mod.Cell(tree, CELL)
    a = c.kind.make_inputs(SEED, c.config, c.traffic, "cpu")
    b = c.kind.make_inputs(SEED, c.config, c.traffic, "cpu")
    assert len(a.boxes) == len(a.frames)
    assert a.sam_weights.keys() == b.sam_weights.keys()
    assert all(torch.equal(a.sam_weights[k], b.sam_weights[k]) for k in a.sam_weights)
    for box_a, box_b, mask in zip(a.boxes, b.boxes, a.frames.mask):
        np.testing.assert_array_equal(box_a, box_b)
        ys, xs = np.nonzero(mask)
        true = np.array([xs.min(), ys.min(), xs.max(), ys.max()])
        assert np.abs(box_a - true).max() <= 8 + 1e-4
        assert (box_a >= 0).all() and box_a[2] <= 159 and box_a[3] <= 119
    other = c.kind.make_inputs(SEED + 1, c.config, c.traffic, "cpu")
    assert any(not np.array_equal(x, y) for x, y in zip(a.boxes, other.boxes))
    assert not torch.equal(a.sam_weights["image_encoder.pos_embed"],
                           other.sam_weights["image_encoder.pos_embed"])


def test_sound_run_is_correct_and_the_control_is_not(tree):
    c = cell_mod.Cell(tree, CELL)
    keep = {}
    r = cell_mod.run(c, SEED, 0.3, False, "cpu", 0.0, keep=keep)
    assert r["correct"] is True, r["checks"]
    assert {"sam_logit_gap_p99", "sam_iou_gap", "refine_gap_p75_mm"} <= set(r["checks"])
    assert "register_ms" in r["metrics"] and "setup_s" in r["metrics"]
    checks, _ = cell_mod.check(c, SEED, keep["state"], "cpu", sys.stderr, control=True)
    assert checks["sam_logit_gap_p99"]["value"] > checks["sam_logit_gap_p99"]["limit"], checks


def test_reference_sam_loads_nothing_of_the_engine():
    from test_bench_imports import FORBIDDEN, _loaded

    mods = _loaded("import reference.sam")
    assert "reference" in mods
    assert not mods & (FORBIDDEN | {"foundationpose_tpu_torch", "fpbench"})
