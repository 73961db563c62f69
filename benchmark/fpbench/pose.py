"""What the pose engine's traffic kinds share: the engine as its
applications build it, the layer spans placed round it, the recorder of what
its refine and score calls were given and gave, the client that drives it
and the plain reference that judges it.
"""

import os

import numpy as np

from .spans import Patches


def build_engine(cfg, obj, device):
    """The engine under test, as its applications build it."""
    from foundationpose_tpu_torch.apps.demo_synthetic import build_estimator
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.engine.estimator import EstimatorConfig

    mesh = meshio.Mesh(obj["vertices"], obj["faces"], vertex_normals=obj["normals"],
                       uv=obj["uv"], texture=obj["texture"])
    return build_estimator(mesh, device=device, config=EstimatorConfig(**cfg["estimator"]),
                           input_size=cfg["input_size"], mode=cfg["mode"])


def install_spans(est, spans):
    """The layer spans of a pose engine: the nets' forwards, the two
    rasterizer kernels' launch calls, the observed warp and the ICP solve."""
    from foundationpose_tpu_torch.engine import geometric
    from foundationpose_tpu_torch.ops import image, raster_cuda

    def shape_of(A, B, *rest, **kw):
        return tuple(A.shape)

    def setup_args(mesh_tensors, poses, K, crop_tfs, out_hw, *rest, **kw):
        cull = rest[1] if len(rest) > 1 else kw.get("backface_cull", False)
        return {"mesh": mesh_tensors, "poses": poses, "K": K, "tfs": crop_tfs,
                "hw": tuple(out_hw), "cull": bool(cull)}

    def raster_args(mesh_tensors, scratch, out_hw, use_light, w_ambient, w_diffuse,
                    with_normal, *rest, **kw):
        return {"with_normal": bool(with_normal)}

    if hasattr(est.refiner, "net"):
        spans.wrap(est.refiner.net, "forward", "refiner.net.forward", keep=shape_of)
        spans.wrap(est.scorer.net, "forward", "scorer.net.forward", keep=shape_of)
    spans.wrap(raster_cuda, "setup_cuda", "raster_cuda.setup_cuda", keep=setup_args)
    spans.wrap(raster_cuda, "rasterize_cuda", "raster_cuda.rasterize_cuda", keep=raster_args)
    spans.wrap(image, "warp_crop_affine", "imops.warp_crop_affine")
    spans.wrap(geometric, "_point_to_plane_delta", "geometric._point_to_plane_delta")


class Recorder:
    """Keeps, per call of the engine, the inputs and outputs of
    ``est.refiner.refine`` and ``est.scorer.score`` (references to the
    tensors, nothing copied); with the geometric refiner also the poses each
    ICP iteration starts from (what it hands ``make_crop_batch``). A step is
    ``(kind, poses in, iterations, gate_px, output, ICP starts)``."""

    def __init__(self, est):
        self.calls, self.current, self._iters = [], None, None
        self.patches = Patches()
        for part, attr in ((est.refiner, "refine"), (est.scorer, "score")):
            self.patches.patch(part, attr, self._keeper(attr))
        if not hasattr(est.refiner, "net"):
            from foundationpose_tpu_torch.engine import geometric

            self.patches.patch(geometric, "make_crop_batch", self._crop)

    def _crop(self, fn, mesh_tensors, poses, *args, **kwargs):
        if self._iters is not None:
            self._iters.append(poses)
        return fn(mesh_tensors, poses, *args, **kwargs)

    def _keeper(self, attr):
        def kept(fn, mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter, *args, **kwargs):
            if attr == "refine":
                self._iters = []
            try:
                out = fn(mesh_tensors, rgb, xyz_map, K, poses, mesh_diameter, *args, **kwargs)
                iters = self._iters
            finally:
                self._iters = None
            if self.current is not None:
                it = args[0] if args else kwargs.get("iteration")
                self.current.append((attr, poses, it, kwargs.get("gate_px", 0), out, iters))
            return out

        return kept

    def begin(self):
        self.current = []

    def end(self, frame, answer):
        self.calls.append({"frame": frame, "steps": self.current, "answer": np.asarray(answer)})
        self.current = None


class Client:
    """One client of a pose engine built from the cell's configuration and
    the run's object: one call at a time, each recorded for the judge.
    ``answers`` holds ``(call index, pool frame, returned pose)`` of every
    recorded call, aligned with ``recorder.calls``."""

    def __init__(self, cfg, traffic, inputs, device):
        self.inputs = inputs
        self.est = build_engine(cfg, inputs.obj, device)
        self.recorder = Recorder(self.est)
        self.i, self.answers = 0, []

    def install_spans(self, spans):
        install_spans(self.est, spans)

    def start(self):
        """What the traffic does before its first call."""

    def clear(self):
        """Forget the calls recorded so far (the warm-up's)."""
        self.recorder.calls.clear()
        self.answers.clear()

    def _record(self, j, call):
        self.recorder.begin()
        pose = call()
        self.recorder.end(j, pose)
        self.answers.append((self.i, j, np.asarray(pose)))
        self.i += 1
        return 1

    def state(self):
        """What the judge reads of the window's calls."""
        return {"inputs": self.inputs, "calls": self.recorder.calls, "answers": self.answers}

    def close(self):
        """Put the engine's functions back and let it go; what the judge
        reads stays."""
        self.recorder.patches.restore()
        self.est = None


def make_reference(cell, inputs, device, quant=None):
    """The plain reference of the cell's configuration over the run's
    object, with the raw weight files of a learned configuration."""
    from reference.pose import Reference

    cfg = cell.config
    wdir = os.path.join(cell.root, cfg["weights"]) if cfg.get("weights") else None
    return Reference(inputs.obj, cfg, device, wdir, quant=quant)


class Inputs:
    """What a run of a pose traffic makes from its seed: the object and a
    pool of frames (``traffic.Frames``)."""

    def __init__(self, obj, frames):
        self.obj, self.frames = obj, frames
