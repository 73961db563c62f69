"""Segment Anything in the port (``models/sam.py``, ``detect/segmenter.py``).

On the CPU at small widths that keep every kind of part (a global block, a
windowed one and a window the grid does not fill, so it is padded; the
two-way decoder; 256 px input, so a 16 x 16 token grid): the port's net in
float32 against the benchmark's plain reference (``benchmark/reference/
sam.py``), that reference against HuggingFace's ``SamModel`` on the same
weights, bfloat16 against float32, the parts the published init leaves at
zero (relative positions, the absolute position embedding) and the window
padding each changing the output, ``BoxSegmenter``'s mask, checkpoints by
either naming, ``run_pose --box``, ``AutoMasker.segment_box`` and
``register`` on a tensor mask.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from foundationpose_tpu_torch.apps import demo_synthetic as demo, run_pose
from foundationpose_tpu_torch.core import validate
from foundationpose_tpu_torch.detect import pipeline
from foundationpose_tpu_torch.detect.segmenter import BoxSegmenter
from foundationpose_tpu_torch.engine.estimator import EstimatorConfig
from foundationpose_tpu_torch.models import sam

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmark"))
from reference import sam as ref_sam  # noqa: E402
from reference import tf32  # noqa: E402

torch.set_num_threads(1)
# 16 x 16 tokens; block 1 global, blocks 0 and 2 in 6 x 6 windows (padded to 18 x 18)
SMALL = sam.SamConfig(encoder_embed_dim=64, encoder_depth=3, encoder_num_heads=4,
                      encoder_global_attn_indexes=(1,), image_size=256, window_size=6,
                      prompt_embed_dim=32, decoder_num_heads=2, decoder_mlp_dim=64,
                      iou_head_hidden_dim=32, dtype="float32")
BOX = (10.0, 8.0, 41.0, 30.0)
INIT = {"init_std": 0.02, "rel_pos_init_std": 0.3}  # the benchmark's draw


def weights(seed, cfg=SMALL):
    """Every tensor of the net drawn from ``seed`` by the benchmark's
    reference, which names and shapes them on its own."""
    return ref_sam.draw_weights({**dataclasses.asdict(cfg), **INIT}, seed, "cpu")


def frame(seed=0, hw=(48, 64)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


def sharpened(seed, scale=6.0):
    """Seeded weights with every parameter but the norms' scaled up, so that
    attention is far from uniform and a wrong head split or bias shows."""
    shapes = ref_sam.param_shapes({**dataclasses.asdict(SMALL), **INIT})
    norms = {k.rsplit(".", 1)[0] for k, (_, kind) in shapes.items() if kind == "norm"}
    return {k: v if shapes[k][1] == "gauss" or k.rsplit(".", 1)[0] in norms else v * scale
            for k, v in weights(seed).items()}


def reference(state, cfg=SMALL, quant=None):
    return ref_sam.Sam(dataclasses.asdict(cfg), state, "cpu", quant=quant)


def _gap(a, b):
    """99th percentile of |a - b| over the RMS of b (the benchmark judge's
    logit number)."""
    return float(torch.quantile((a - b).abs().flatten(), 0.99) / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_reference_in_float32(seed):
    state = sharpened(seed)
    seg = BoxSegmenter(state, SMALL, device="cpu")
    mask = seg(frame(seed), BOX)
    with torch.no_grad(), tf32(False):
        logits, iou, ref_mask = reference(state).predict(frame(seed), BOX)
    scale = float(logits.abs().max())
    assert scale > 0.1  # sharpened weights: logits of order one
    # the same float32 arithmetic in another order (fused attention, LayerNorm
    # by its own kernel): rounding only
    assert float((seg.low_res_logits - logits).abs().max()) <= 1e-4 * scale
    assert float((seg.iou_predictions - iou).abs().max()) <= 1e-4 * max(float(iou.abs().max()), 1)
    flips = int((mask != ref_mask).sum())
    assert flips <= 2, flips  # only where an upsampled logit sits within rounding of 0


def test_reference_matches_huggingface_sam():
    pytest.importorskip("transformers")
    from transformers import SamConfig as HFConfig, SamModel
    from transformers.models.sam.configuration_sam import (
        SamMaskDecoderConfig, SamPromptEncoderConfig, SamVisionConfig)

    # segment_anything's two-way transformer takes nn.LayerNorm's eps 1e-5;
    # HuggingFace's default is 1e-6, so it is set here
    hc = HFConfig(
        vision_config=SamVisionConfig(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                                      image_size=256, patch_size=16, output_channels=32,
                                      window_size=6, global_attn_indexes=[1], num_pos_feats=16),
        prompt_encoder_config=SamPromptEncoderConfig(hidden_size=32, image_size=256,
                                                     patch_size=16),
        mask_decoder_config=SamMaskDecoderConfig(hidden_size=32, mlp_dim=64, num_attention_heads=2,
                                                 iou_head_hidden_dim=32, layer_norm_eps=1e-5))
    hc._attn_implementation = "eager"
    hf = SamModel(hc).eval()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # every parameter drawn: HuggingFace's init zeroes some
        for name, p in hf.named_parameters():
            norm = "norm" in name and name.endswith("weight")
            p.copy_(torch.randn(p.shape, generator=gen) * 0.15 + (1.0 if norm else 0.0))
    state = sam.from_hf_state_dict(hf.state_dict())
    cfg = sam.config_from_state_dict(state, decoder_num_heads=2, dtype="float32")
    assert cfg == SMALL
    img = torch.randn(1, 3, 256, 256, generator=gen)
    box = torch.tensor([20.0, 30.0, 150.0, 120.0])
    with torch.no_grad(), tf32(False):
        out = hf(pixel_values=img, input_boxes=box[None, None], multimask_output=True)
        r = reference(state, cfg)
        logits, iou = r.decode(r.encode(img), *r.prompt(box))
    scale = float(logits.abs().max())
    assert scale > 0.1
    assert float((out.pred_masks[0, 0] - logits).abs().max()) <= 1e-4 * scale
    assert float((out.iou_scores[0, 0] - iou).abs().max()) <= 1e-4 * max(float(iou.abs().max()), 1)


def test_bfloat16_within_its_tolerance():
    state = weights(2)
    f32 = BoxSegmenter(state, SMALL, device="cpu")
    bf16 = BoxSegmenter(state, dataclasses.replace(SMALL, dtype="bfloat16"), device="cpu")
    assert bf16.net.image_encoder.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert bf16.net.image_encoder.blocks[0].norm1.weight.dtype == torch.float32
    f32(frame(), BOX)
    bf16(frame(), BOX)
    # bfloat16 keeps 8 bits of mantissa (0.4 % a rounding); through three
    # blocks and the decoder the logits read ~3 % off at the 99th percentile
    gap = _gap(bf16.low_res_logits, f32.low_res_logits)
    assert 1e-4 < gap < 0.1, gap
    assert float((bf16.iou_predictions - f32.iou_predictions).abs().max()) < 1e-3


def _logits(state, cfg=SMALL, rgb=None):
    seg = BoxSegmenter(state, cfg, device="cpu")
    seg(frame() if rgb is None else rgb, BOX)
    return seg.low_res_logits


@pytest.mark.parametrize("part", ["rel_pos_h", "rel_pos_w", "pos_embed"])
def test_seeded_parts_change_the_output(part):
    state = weights(3)
    assert all(float(v.abs().max()) > 0 for v in state.values())  # every parameter drawn
    zeroed = {k: torch.zeros_like(v) if k.endswith(part) else v for k, v in state.items()}
    assert _gap(_logits(zeroed), _logits(state)) > 1e-3


def test_kept_rel_pos_tables_follow_the_weights():
    """The gathered relative-position tables are kept from one call to the
    next, and gathered anew once a parameter is written: a segmenter that
    loads other weights in place reads as one built with them."""
    seg = BoxSegmenter(weights(7), SMALL, device="cpu")
    seg(frame(), BOX)
    first = seg.low_res_logits
    assert all(b.attn._tables is not None for b in seg.net.image_encoder.blocks)
    seg(frame(), BOX)
    assert torch.equal(seg.low_res_logits, first)
    other = weights(8)
    seg.net.load_state_dict(other)
    seg(frame(), BOX)
    assert torch.equal(seg.low_res_logits, _logits(other))
    assert not torch.equal(seg.low_res_logits, first)


def test_window_padding_takes_part(monkeypatch):
    """The grid's bottom and right windows hold padded tokens, which are keys
    of the window's attention: pad with ones instead of zeros, and the
    tokens of those windows change while the first window's do not."""
    x = torch.randn(1, 16, 16, 64, generator=torch.Generator().manual_seed(0))
    blk = sam.build_sam(SMALL, "cpu", weights(4)).image_encoder.blocks[0]
    assert blk.window_size == 6
    with torch.no_grad():
        ref = blk(x)
        pad = sam.window_partition

        def ones(t, window):
            B, H, W, C = t.shape
            big = torch.ones(B, H + (-H) % window, W + (-W) % window, C)
            big[:, :H, :W] = t
            return pad(big, window)

        monkeypatch.setattr(sam, "window_partition", ones)
        other = blk(x)
    assert torch.equal(other[:, :6, :6], ref[:, :6, :6])
    assert float((other[:, 12:, 12:] - ref[:, 12:, 12:]).abs().max()) > 1e-3


def test_box_segmenter_mask_and_outputs():
    seg = BoxSegmenter(weights(6), SMALL, device="cpu")
    rgb = frame(hw=(40, 72))
    mask = seg(torch.from_numpy(rgb), BOX)  # a tensor frame as well as a numpy one
    assert mask.shape == (40, 72) and mask.dtype == torch.bool
    assert seg.mask is mask
    assert seg.low_res_logits.shape == (3, 64, 64) and seg.iou_predictions.shape == (3,)
    assert torch.equal(seg(rgb, BOX), mask)
    # the mask of the highest predicted IoU, upsampled and cropped as SAM does
    with torch.no_grad(), tf32(False):
        _, _, ref_mask = reference(seg.net.state_dict()).predict(rgb, BOX)
    assert int((mask != ref_mask).sum()) <= 2


def test_published_widths():
    h = sam.SamConfig()
    assert (h.encoder_embed_dim, h.encoder_depth, h.encoder_num_heads) == (1280, 32, 16)
    assert h.encoder_global_attn_indexes == (7, 15, 23, 31) and h.window_size == 14
    assert (h.image_size, h.grid, h.prompt_embed_dim, h.decoder_mlp_dim) == (1024, 64, 256, 2048)
    with torch.device("meta"):
        net = sam.Sam(h)
    blocks = net.image_encoder.blocks
    assert blocks[7].attn.rel_pos_h.shape == (127, 80) and blocks[0].attn.rel_pos_w.shape == (27, 80)
    assert net.image_encoder.pos_embed.shape == (1, 64, 64, 1280)
    n = sum(p.numel() for p in net.parameters())
    assert 636e6 < n < 642e6  # ViT-H SAM: ~641 M parameters
    assert sam.config_from_state_dict(net.state_dict()) == h
    # the benchmark's reference names and shapes every tensor on its own
    shapes = ref_sam.param_shapes({**dataclasses.asdict(h), **INIT})
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: shape for k, (shape, _) in shapes.items()}


@pytest.mark.parametrize("dropped", ["image_encoder.blocks.1.attn.qkv.bias",
                                     "image_encoder.blocks.0.attn.rel_pos_w"])
def test_checkpoint_missing_a_tensor_is_refused(dropped):
    state = {k: v for k, v in weights(1).items() if k != dropped}
    with pytest.raises(RuntimeError, match="Missing key"):
        BoxSegmenter(state, SMALL, device="cpu")


def test_checkpoint_by_path(tmp_path):
    state = weights(7)
    path = str(tmp_path / "sam_small.pth")
    torch.save(state, path)
    # the config comes from the shapes; decoder heads are not in them (8 in
    # every published size), so this one is given
    seg = BoxSegmenter(path, sam.config_from_state_dict(torch.load(path), decoder_num_heads=2,
                                                        dtype="float32"), device="cpu")
    seg(frame(), BOX)
    assert torch.equal(seg.low_res_logits, _logits(state))


def test_run_pose_box(tmp_path, monkeypatch):
    cfg8 = dataclasses.replace(SMALL, decoder_num_heads=8)
    path = str(tmp_path / "sam.pth")
    torch.save(weights(8, cfg8), path)
    monkeypatch.setenv("SAM_PATH", path)
    rgb, depth = frame(), np.ones((48, 64), np.float32)
    args = run_pose.build_parser().parse_args(
        ["--rgb", "a", "--depth", "b", "--intrinsics", "c", "--mesh", "d", "--box", "10,8,41,30",
         "--device", "cpu"])
    mask = run_pose.get_mask(args, rgb, depth)
    assert mask.shape == (48, 64) and mask.dtype == torch.bool
    seg = BoxSegmenter(path, device="cpu")
    assert seg.config.dtype == "bfloat16" and seg.config.encoder_embed_dim == 64
    args.box = "1,2,3"
    with pytest.raises(SystemExit, match="x0,y0,x1,y1"):
        run_pose.get_mask(args, rgb, depth)
    monkeypatch.delenv("SAM_PATH")
    args.box = "10,8,41,30"
    with pytest.raises(SystemExit, match="SAM checkpoint"):
        run_pose.get_mask(args, rgb, depth)


def test_automasker_segment_box_is_the_box_segmenter():
    masker = object.__new__(pipeline.AutoMasker)
    masker.segmenter = BoxSegmenter(weights(9), SMALL, device="cpu")
    mask = masker.segment_box(frame(), BOX)
    assert mask.dtype == torch.bool and torch.equal(mask, masker.segmenter.mask)


def test_check_mask_takes_tensors():
    m = torch.zeros(4, 5, dtype=torch.bool)
    assert validate.check_mask(m, (4, 5)) is m
    assert validate.check_mask(m.to(torch.uint8), (4, 5)).dtype == torch.uint8
    with pytest.raises(ValueError, match="bool or uint8"):
        validate.check_mask(m.float(), (4, 5))
    with pytest.raises(ValueError, match="does not match"):
        validate.check_mask(m, (5, 4))
    assert isinstance(validate.check_mask(np.zeros((4, 5)), (4, 5)), np.ndarray)


@pytest.fixture(scope="module")
def registered():
    """A small learned engine on the demo scene and its pose from the numpy
    mask."""
    scene = demo.make_scene((120, 160), device="cpu")
    est = demo.build_estimator(scene["mesh"], device="cpu", input_size=32,
                               config=EstimatorConfig(min_n_views=4, inplane_step=180,
                                                      register_iterations=1,
                                                      final_refine_iterations=1,
                                                      final_refine_top_k=2))
    pose = est.register(scene["K"], scene["rgb"], scene["depth"], np.asarray(scene["mask"]))
    return est, scene, pose, est.scores.copy()


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_register_on_a_tensor_mask_is_the_numpy_pose(registered, dtype):
    est, scene, pose, scores = registered
    mask = torch.as_tensor(np.asarray(scene["mask"]) > 0).to(dtype)
    np.testing.assert_array_equal(est.register(scene["K"], scene["rgb"], scene["depth"], mask),
                                  pose)
    np.testing.assert_array_equal(est.scores, scores)
