"""H5-backed training datasets for the pose networks.

The port's own copy of foundationpose_tpu/models/h5data.py: the same file
layout, so an archive written by either package reads in the other;
``generate_dataset`` renders with the port's ``models/datagen.py`` (K1s +
K1r on the card). ``h5py`` is imported where it is used, never at import.

Counterpart of the reference's learning/datasets/h5_dataset.py (PairH5Dataset
:20-127, TripletH5Dataset :132-179): persistent archives of
render-and-compare training pairs. The reference's archives store png-encoded
crops grouped by object key with per-group normalizers
(PoseRefinePairH5Dataset :190-219); ours store the already-normalized network
inputs produced by ``models.datagen`` (layout documented below), so reading a
batch is one HDF5 slice + zero transforms at train time.

Layout (one file):
  /meta: attrs input_size, c_in, trans_normalizer(3), rot_normalizer
  /A        (N,S,S,6) float16   hypothesis crops [rgb|xyz]
  /B        (N,S,S,6) float16   observed crops
  /trans_gt (N,3)     float32   egocentric translation delta
  /rot_gt   (N,3,3)   float32   egocentric rotation delta
  /adds     (N,)      float32   ADD of the hypothesis (scorer ranking)
"""

from __future__ import annotations

import logging

import numpy as np


class PairH5Writer:
    def __init__(self, path, input_size=160, c_in=6,
                 trans_normalizer=(0.02, 0.02, 0.02),
                 rot_normalizer=0.3490658503988659):
        import h5py

        self.f = h5py.File(path, "w")
        meta = self.f.create_group("meta")
        meta.attrs["input_size"] = input_size
        meta.attrs["c_in"] = c_in
        meta.attrs["trans_normalizer"] = np.asarray(trans_normalizer)
        meta.attrs["rot_normalizer"] = rot_normalizer
        self._init = False
        self.n = 0

    def append(self, batch):
        """batch: dict with A, B, trans_gt, rot_gt, (adds)."""
        import h5py

        arrays = {
            "A": np.asarray(batch["A"], np.float16),
            "B": np.asarray(batch["B"], np.float16),
            "trans_gt": np.asarray(batch["trans_gt"], np.float32),
            "rot_gt": np.asarray(batch["rot_gt"], np.float32),
        }
        if "adds" in batch:
            arrays["adds"] = np.asarray(batch["adds"], np.float32)
        n_new = len(arrays["A"])
        if not self._init:
            for k, v in arrays.items():
                self.f.create_dataset(
                    k, data=v, maxshape=(None, *v.shape[1:]),
                    chunks=(min(64, n_new), *v.shape[1:]),
                )
            self._init = True
        else:
            for k, v in arrays.items():
                d = self.f[k]
                d.resize(self.n + n_new, axis=0)
                d[self.n :] = v
        self.n += n_new

    def close(self):
        self.f.close()


class PairH5Dataset:
    """Random-batch reader feeding ``models.training`` steps."""

    def __init__(self, path):
        import h5py

        self.f = h5py.File(path, "r")
        self.n = self.f["A"].shape[0]
        meta = self.f["meta"].attrs
        self.input_size = int(meta["input_size"])
        self.trans_normalizer = np.asarray(meta["trans_normalizer"])
        self.rot_normalizer = float(meta["rot_normalizer"])
        logging.info("PairH5Dataset: %d samples @ %d px", self.n, self.input_size)

    def __len__(self):
        return self.n

    def sample_batch(self, rng, batch_size):
        ids = np.sort(rng.choice(self.n, size=min(batch_size, self.n), replace=False))
        out = {
            "A": self.f["A"][ids].astype(np.float32),
            "B": self.f["B"][ids].astype(np.float32),
            "trans_gt": self.f["trans_gt"][ids],
            "rot_gt": self.f["rot_gt"][ids],
        }
        if "adds" in self.f:
            out["adds"] = self.f["adds"][ids]
        return out

    def close(self):
        self.f.close()


class PrefetchLoader:
    """Double-buffered host data pipeline: worker threads read random batches
    ahead of the train loop into a bounded queue, so the device step never
    waits on HDF5 I/O (the reference trains with a 20-worker torch DataLoader,
    training_config.py:44-45; the host loop only needs enough lead to
    hide one read, so a small thread pool + queue is the idiomatic analog).

    Each worker opens its OWN file handle (h5py handles are not safe for
    concurrent reads). Iterate forever; call ``close()`` (or use as a context
    manager) to stop the workers.
    """

    def __init__(self, path, batch_size, n_workers=2, prefetch=4, seed=0):
        import queue
        import threading

        self.path = path
        self.batch_size = batch_size
        self._q = queue.Queue(maxsize=max(2, prefetch))
        self._stop = threading.Event()
        self._workers = []
        for i in range(max(1, n_workers)):
            t = threading.Thread(
                target=self._worker, args=(i, seed + i), daemon=True
            )
            t.start()
            self._workers.append(t)

    def _worker(self, idx, seed):
        import queue

        ds = PairH5Dataset(self.path)
        rng = np.random.default_rng(seed)
        try:
            while not self._stop.is_set():
                batch = ds.sample_batch(rng, self.batch_size)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        finally:
            ds.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._stop.set()
        # unblock any worker waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        for t in self._workers:
            t.join(timeout=2.0)


def generate_dataset(path, mesh, K, n_batches=50, batch=32, input_size=160,
                     seed=0, with_scores=False, device=None):
    """Render a training archive with ``models.datagen`` on ``device``
    (``None`` = cuda) from a generator seeded with ``seed``."""
    import torch

    from foundationpose_tpu_torch import resolve_device
    from foundationpose_tpu_torch.core import geometry as geo, meshio
    from foundationpose_tpu_torch.models import datagen
    from foundationpose_tpu_torch.ops import raster

    device = resolve_device(device)
    bounds = mesh.bounds
    centered = mesh.translated(-(bounds[0] + bounds[1]) / 2)
    mt = raster.make_mesh_tensors(centered, device=device)
    diameter = meshio.compute_mesh_diameter(mesh=centered)
    K_t = geo.as_f32(K, device)
    pts = geo.as_f32(centered.vertices, device)
    writer = PairH5Writer(path, input_size=input_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(n_batches):
        data = datagen.make_refine_batch(gen, mt, K_t, diameter, batch=batch,
                                         input_size=input_size)
        rec = {k: data[k].cpu().numpy() for k in ("A", "B", "trans_gt", "rot_gt")}
        if with_scores:
            ph = geo.transform_pts(pts, data["poseA"])
            pg = geo.transform_pts(pts, data["poseB"])
            rec["adds"] = torch.linalg.norm(ph - pg, dim=-1).mean(dim=-1).cpu().numpy()
        writer.append(rec)
    writer.close()
    return path
