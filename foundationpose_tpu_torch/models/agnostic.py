"""Object-agnostic RefineNet/ScoreNet: the corpus trainer and its checkpoint.

Counterpart of foundationpose_tpu/models/agnostic.py: ONE refiner and ONE
scorer trained over a randomised mesh corpus (``models/corpus.py``) with
on-device render-and-compare data (``models/datagen.py``), conditioned on the
object only through its renders, and the checkpoint directory that carries
them (``refiner.npz`` + ``scorer.npz`` + ``meta.json``; flax key paths,
float16 storage — the format both packages read and write).

Differences from the JAX trainer, by design:

- Each corpus mesh keeps its own tensors (no shared shape bucket: that
  padding exists so XLA compiles one program). The textured and the
  vertex-coloured meshes still form two groups whose chunks interleave in
  the same deterministic proportion.
- The mesh of a step is chosen on the host from a CPU generator; the data
  draws come from a generator on the mesh tensors' device.
- The losses of a chunk stay on the device and are read once per chunk.
- The resume snapshot is a ``torch.save`` of the net, the optimiser (with
  its skip counter), ``done`` and both generators' states, written
  atomically (``os.replace``).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.models.convert import load_flax_npz, state_dict_to_flax_params

# ---------------------------------------------------------------------------
# flat npz (de)serialisation in the JAX package's key-path format


def save_params_npz(path, net, dtype=np.float32):
    """``net``'s parameters as ``"params/.../kernel|bias|scale"`` arrays,
    stored as ``dtype`` (None keeps float32)."""
    flat = state_dict_to_flax_params(net)
    if dtype is not None:
        flat = {k: v.astype(dtype) for k, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_params_npz(path, net):
    """Load a ``save_params_npz`` file (of either package) into ``net``
    (strict: no missing, unexpected or wrong-shaped entry)."""
    load_flax_npz(path, net)
    return net


# ---------------------------------------------------------------------------
# corpus preparation


def _sample_surface_points(mesh, n=512, seed=0):
    """Fixed-count face-area-weighted surface samples (the scorer's ADD
    supervision)."""
    rng = np.random.default_rng(seed)
    v, f = mesh.vertices, mesh.faces
    tri = v[f]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    p = area / max(area.sum(), 1e-12)
    idx = rng.choice(len(f), n, p=p)
    r1, r2 = rng.uniform(size=(2, n))
    s = np.sqrt(r1)
    w = np.stack([1 - s, s * (1 - r2), s * r2], axis=-1)  # (n,3) barycentric
    return (tri[idx] * w[..., None]).sum(axis=1).astype(np.float32)


def prepare_corpus(n_meshes, seed=0, max_faces=4096, n_pts=512, device=None):
    """Centre the corpus meshes and build each one's mesh tensors (its own
    face bucket, ``max_faces`` decimation), diameter and surface samples on
    ``device``. Returns a list of dicts."""
    from foundationpose_tpu_torch.core import meshio
    from foundationpose_tpu_torch.models import corpus
    from foundationpose_tpu_torch.ops import raster

    device = resolve_device(device)
    prepped = []
    for i, mesh in enumerate(corpus.build_corpus(n_meshes, seed=seed)):
        b = mesh.bounds
        centered = mesh.translated(-(b[0] + b[1]) / 2)
        mt = raster.make_mesh_tensors(centered, max_faces=max_faces, bucket=True, device=device)
        pts = _sample_surface_points(centered, n=n_pts, seed=seed + i)
        prepped.append({
            "mesh": centered,
            "mt": mt,
            "diameter": float(meshio.compute_mesh_diameter(mesh=centered)),
            "pts": torch.from_numpy(pts).to(device),
            "textured": "tex" in mt,
        })
    return prepped


def _groups(prepped):
    """Vertex-coloured then textured meshes (the JAX trainer's two groups)."""
    groups = []
    for flag in (False, True):
        sel = [p for p in prepped if p["textured"] == flag]
        if sel:
            dev = sel[0]["mt"]["pos"].device
            groups.append({"meshes": sel, "n": len(sel),
                           "diameters": torch.tensor([p["diameter"] for p in sel],
                                                     dtype=torch.float32).to(dev)})
    return groups


def chunk_schedule(groups, steps, chunk):
    """Deterministic proportional interleave of the groups' chunks."""
    weights = np.array([g["n"] for g in groups], np.float64)
    weights = weights / weights.sum()
    sched, acc = [], np.zeros(len(groups))
    for _ in range((steps + chunk - 1) // chunk):
        acc += weights
        gi = int(np.argmax(acc))
        acc[gi] -= 1.0
        sched.append(gi)
    return sched


# ---------------------------------------------------------------------------
# trainers


def _save_resume(path, net, opt, done, host_gen, dev_gen):
    state = {"net": net.state_dict(), "opt": opt.state_dict(), "done": done,
             "host_gen": host_gen.get_state(), "dev_gen": dev_gen.get_state()}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def _load_resume(path, net, opt, host_gen, dev_gen):
    state = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict(state["net"])
    opt.load_state_dict(state["opt"])
    host_gen.set_state(state["host_gen"])
    dev_gen.set_state(state["dev_gen"])
    return int(state["done"])


def _run_chunked(step_fn, groups, net, opt, steps, chunk, seed, tag, log_cb, t0,
                 resume_path=None, ckpt_every=2500, device=None, stop_after=None):
    """Run the chunks of ``chunk_schedule``; ``step_fn(group, mesh_index,
    dev_gen)`` does one training step and returns its loss on the device.

    ``resume_path``: a snapshot written when ``done`` crosses a multiple of
    ``ckpt_every``; if it exists, training CONTINUES from it. ``stop_after``:
    return after that many chunks of this call (a cut run; tests)."""
    host_gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    done = 0
    if resume_path and os.path.exists(resume_path):
        done = _load_resume(resume_path, net, opt, host_gen, dev_gen)
        logging.info("%s resumed at step %d from %s", tag, done, resume_path)
    sched = chunk_schedule(groups, steps, chunk)
    losses, n_run = [], 0
    for ci, gi in enumerate(sched):
        if ci * chunk < done:
            continue  # trained before the resume point
        if stop_after is not None and n_run == stop_after:
            return losses
        g = groups[gi]
        picks = torch.randint(0, g["n"], (chunk,), generator=host_gen).tolist()
        chunk_losses = torch.stack([step_fn(g, mi, dev_gen) for mi in picks])
        losses.append(chunk_losses.cpu().numpy())  # the one host read per chunk
        done += chunk
        n_run += 1
        if resume_path and (done % ckpt_every < chunk):
            _save_resume(resume_path, net, opt, done, host_gen, dev_gen)
        if log_cb and (ci % max(1, len(sched) // 20) == 0 or ci == len(sched) - 1):
            mean = float(np.mean(losses[-1]))
            logging.info("%s step %d loss %.4f (%.0fs)", tag, done, mean, time.time() - t0)
            log_cb(done, mean)
    if resume_path and os.path.exists(resume_path):
        os.remove(resume_path)  # finished: the final checkpoint supersedes it
    return losses


def _stats(losses, t0):
    all_l = np.concatenate(losses) if losses else np.zeros(1)
    return {"loss_first": float(np.mean(all_l[:50])), "loss_last": float(np.mean(all_l[-50:])),
            "steps": int(len(all_l)), "seconds": round(time.time() - t0, 1),
            "chunk_means": [float(np.mean(c)) for c in losses]}


def corpus_optimizer(net, lr, steps):
    """The corpus trainers' recipe: warmup (min(500, steps / 20)) -> cosine
    to 2 % of ``lr`` at ``steps``, clip at global norm 1, non-finite updates
    skipped (up to 200 in a row)."""
    from foundationpose_tpu_torch.models import training

    sched = training.warmup_cosine_decay_schedule(
        0.0, lr, min(500, max(steps // 20, 1)), steps, lr * 0.02)
    return training.Optimizer(net.parameters(), sched, clip_norm=1.0,
                              max_consecutive_errors=200)


def _train_corpus(net, make_step, prepped, steps, lr, seed, data_seed, tag, chunk, log_cb,
                  resume_path, ckpt_every, stop_after):
    """``net`` (flax-style init from ``seed``) trained by the corpus recipe on
    draws seeded with ``data_seed``; ``make_step(net, opt)`` returns the
    ``step_fn`` of ``_run_chunked``."""
    from foundationpose_tpu_torch.models import convert

    dev = prepped[0]["mt"]["pos"].device
    net = convert.flax_init(net, seed).to(dev)
    opt = corpus_optimizer(net, lr, steps)
    t0 = time.time()
    losses = _run_chunked(make_step(net, opt), _groups(prepped), net, opt, steps, chunk,
                          data_seed, tag, log_cb, t0,
                          resume_path=resume_path, ckpt_every=ckpt_every, device=dev,
                          stop_after=stop_after)
    return net, _stats(losses, t0)


def train_agnostic_refiner(prepped, K, steps=20000, batch=32, input_size=160, lr=2e-4,
                           seed=0, chunk=25, log_cb=None, resume_path=None, ckpt_every=2500,
                           stop_after=None):
    """ONE RefineNet over the whole corpus, float32 (TF32 off), from a
    flax-style init; warmup -> cosine with a clip at global norm 1 and
    non-finite updates skipped (the JAX package's validated recipe).
    Returns (net, stats)."""
    from foundationpose_tpu_torch.models import datagen, training
    from foundationpose_tpu_torch.models.refine_net import RefineNet

    K_t = torch.as_tensor(np.asarray(K, np.float32)).to(prepped[0]["mt"]["pos"].device)

    def make_step(net, opt):
        def step(g, mi, gen):
            p = g["meshes"][mi]
            data = datagen.make_refine_batch(gen, p["mt"], K_t, p["diameter"], batch=batch,
                                             input_size=input_size, augment=True)
            return training.refiner_train_step_multimesh(net, opt, data, g["diameters"][mi])
        return step

    return _train_corpus(RefineNet(c_in=6), make_step, prepped, steps, lr, seed, seed + 1,
                         "refiner[agnostic]", chunk, log_cb, resume_path, ckpt_every, stop_after)


def train_agnostic_scorer(prepped, K, steps=15000, n_hyp=16, input_size=160, lr=5e-4,
                          seed=0, chunk=25, log_cb=None, resume_path=None, ckpt_every=2500,
                          stop_after=None, dtype=torch.float32):
    """ONE ScoreNetMultiPair (group norm, residual attention: the
    from-scratch architecture) over the whole corpus, same recipe as the
    refiner. ``dtype=torch.bfloat16`` runs the net's compute in bf16, as the
    JAX package's ``dtype=jnp.bfloat16``; its parameters, gradients and
    optimiser stay float32. Returns (net, stats)."""
    from foundationpose_tpu_torch.models import datagen, training
    from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

    K_t = torch.as_tensor(np.asarray(K, np.float32)).to(prepped[0]["mt"]["pos"].device)

    def make_step(net, opt):
        def step(g, mi, gen):
            p = g["meshes"][mi]
            data = datagen.make_score_batch(gen, p["mt"], K_t, p["diameter"], p["pts"],
                                            n_hyp=n_hyp, input_size=input_size, augment=True)
            return training.scorer_train_step(net, opt, data)
        return step

    return _train_corpus(ScoreNetMultiPair(c_in=6, norm="group", residual_attn=True,
                                           dtype=dtype),
                         make_step, prepped, steps, lr, seed, seed + 2, "scorer[agnostic]", chunk,
                         log_cb, resume_path, ckpt_every, stop_after)


# ---------------------------------------------------------------------------
# checkpoint directory: refiner.npz + scorer.npz + meta.json


def save_agnostic(out_dir, net_r, net_s, meta):
    """float16 storage: halves the artifact; the parameters are O(1e-2..1),
    so the round (2^-11 relative) is far below training noise."""
    os.makedirs(out_dir, exist_ok=True)
    save_params_npz(os.path.join(out_dir, "refiner.npz"), net_r, dtype=np.float16)
    save_params_npz(os.path.join(out_dir, "scorer.npz"), net_s, dtype=np.float16)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    logging.info("agnostic checkpoint saved to %s", out_dir)


def load_agnostic(ckpt_dir, device=None, input_size=None):
    """Build (PoseRefiner, PoseScorer, meta) from an agnostic checkpoint dir.
    ``device=None`` means cuda. The nets compute in bfloat16 on the card and
    in float32 on the CPU."""
    from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig
    from foundationpose_tpu_torch.engine.scorer import PoseScorer, ScorerConfig

    device = resolve_device(device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    px = int(input_size or meta["input_size"])
    refiner = PoseRefiner(RefinerConfig(input_size=px, dtype=dtype), device=device)
    load_flax_npz(os.path.join(ckpt_dir, "refiner.npz"), refiner.net)
    scorer = PoseScorer(
        ScorerConfig(input_size=px, dtype=dtype, norm="group", residual_attn=True),
        device=device,
    )
    load_flax_npz(os.path.join(ckpt_dir, "scorer.npz"), scorer.net)
    return refiner, scorer, meta

