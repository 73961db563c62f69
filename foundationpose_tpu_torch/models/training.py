"""Training steps and the optimiser for the pose networks.

Counterpart of foundationpose_tpu/models/training.py (``refiner_loss``,
``scorer_loss``, the three train steps, ``make_refiner_train_state``) and
of the optax recipes the JAX
package trains with. The steps are plain functions over ``(net, optimiser,
batch)``: forward in float32, autograd backward, one optimiser update.

``Optimizer`` reproduces optax's arithmetic, not only its names:
``[apply_if_finite](chain([clip_by_global_norm], adam(lr or schedule)))``.

- Adam with b1 0.9, b2 0.999, eps 1e-8 and optax's bias correction.
- Clip by global norm as optax computes it: ``(g / ||g||) * max_norm`` when
  ``||g|| >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
  norm and scales otherwise).
- A schedule is read at the count before the update, so a warmup from 0
  gives lr 0 on step 0.
- ``max_consecutive_errors``: optax's ``apply_if_finite``. A step whose
  gradients hold a non-finite value is dropped — parameters, both moments
  and the count stay as they were — and a consecutive-error counter rises;
  past ``max_consecutive_errors`` in a row the update is applied anyway.
  The test and the skip are tensor ``where``s on the device: the host never
  reads whether a step was skipped.
- The arithmetic is multi-tensor (``torch._foreach_*``), in optax's order of
  operations, so a step costs a few launches for all parameters.
"""

from __future__ import annotations

import math

import torch


def refiner_loss(net, batch, mesh_diameter):
    """L2 on the DECODED deltas: the outputs go through the inference decode
    (``engine.refiner.decode_delta``: diameter scaling, tanh bounds, the
    rotation transpose) and are compared with the egocentric ground truth,
    so train and inference decode alike. Translation error is normalised by
    the mesh radius. ``mesh_diameter``: a float or a 0-d tensor."""
    from foundationpose_tpu_torch.engine.refiner import RefinerConfig, decode_delta

    out = net(batch["A"], batch["B"])
    trans_delta, rot_mat_delta = decode_delta(out, RefinerConfig(rot_rep=net.rot_rep),
                                              mesh_diameter)
    radius = mesh_diameter / 2.0
    loss_t = (((trans_delta - batch["trans_gt"]) / radius) ** 2).sum(dim=-1).mean()
    loss_r = ((rot_mat_delta - batch["rot_gt"]) ** 2).sum(dim=(-2, -1)).mean()
    return loss_t + loss_r


def scorer_loss(net, batch, mode="listwise", temperature=0.25, margin=1e-4):
    """Ranking supervision: hypotheses with lower ADD score higher.

    ``pairwise``: hinge over every pair whose errors differ by more than
    ``margin``. ``listwise`` (default): cross-entropy against the soft target
    softmax(-e / temperature) of the range-normalised errors e, plus a
    pointwise anchor regressing each score to -e (it removes the zero-gradient
    saddle of collapsed features)."""
    out = net(batch["A"], batch["B"], batch["A"].shape[0])
    s = out["score_logit"].reshape(-1)
    err = batch["adds"].reshape(-1)
    if mode == "pairwise":
        better = err[:, None] < err[None, :] - margin
        diff = s[None, :] - s[:, None]
        hinge = torch.clamp(0.5 + diff, min=0.0) * better
        return hinge.sum() / better.sum().clamp(min=1.0)
    e = (err - err.min()) / (err.max() - err.min()).clamp(min=1e-9)
    target = torch.softmax(-e / temperature, dim=-1)
    ce = -(target * torch.log_softmax(s, dim=-1)).sum()
    pointwise = ((s - (-e)) ** 2).mean()
    return ce + pointwise


# ---------------------------------------------------------------------------
# learning-rate schedules: functions of the int32 step count (a device tensor)


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0):
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to ``end_value`` at
    ``decay_steps`` (warmup included), computed in float32 like optax."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)
    if cos_steps <= 0:
        raise ValueError(f"decay_steps must exceed warmup_steps ({decay_steps}, {warmup_steps})")

    def schedule(count):
        c = count.clamp(0, warmup_steps).float()
        frac = 1.0 - c / warmup_steps
        warm = (init_value - peak_value) * frac + peak_value
        k = torch.clamp_max((count - warmup_steps).float(), cos_steps)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * k / cos_steps))
        decayed = peak_value * ((1.0 - alpha) * cosine + alpha)
        return torch.where(count < warmup_steps, warm, decayed)

    return schedule


class Optimizer:
    """optax ``[apply_if_finite](chain([clip_by_global_norm(clip_norm)],
    adam(lr)))`` over ``params``; ``lr`` is a float or a schedule of the step
    count. All state lives on the parameters' device."""

    def __init__(self, params, lr, *, clip_norm=None, max_consecutive_errors=None,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.clip_norm = lr, clip_norm
        self.max_consecutive_errors = max_consecutive_errors
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads=None):
        """One update from ``grads`` (default: each parameter's ``.grad``).
        Multi-tensor (``torch._foreach_*``) arithmetic in optax's order: a
        few launches per step for all parameters instead of ~20 each."""
        grads = [p.grad for p in self.params] if grads is None else list(grads)
        dev = self.count.device
        if self.max_consecutive_errors is not None:  # tested on the gradients as given
            # g * 0 is 0 where g is finite and NaN elsewhere; a sum of
            # squares keeps the NaN and cannot overflow
            zeros = torch._foreach_mul(grads, 0.0)
            finite = torch.isfinite(torch.stack(torch._foreach_norm(zeros))).all()
        if self.clip_norm is not None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            trigger = g_norm < self.clip_norm
            one = torch.ones((), device=dev)
            # (g / ||g||) * max_norm past the threshold, g / 1 * 1 = g below it
            grads = torch._foreach_mul(
                torch._foreach_div(grads, torch.where(trigger, one, g_norm)),
                torch.where(trigger, one, one * self.clip_norm))
        count_inc = self.count + 1
        b1, b2 = self.b1, self.b2
        # b ** count in float32 on the device (a filled tensor, not an upload)
        bc1 = 1.0 - torch.pow(torch.full((), b1, device=dev), count_inc.float())
        bc2 = 1.0 - torch.pow(torch.full((), b2, device=dev), count_inc.float())
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(self.mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                torch._foreach_mul(self.nu, b2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        update = torch._foreach_mul(update, -1 * lr)
        if self.max_consecutive_errors is None:
            torch._foreach_add_(self.params, update)
            self.mu, self.nu = mu, nu
            self.count = count_inc
            return
        self.notfinite_count = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                           self.notfinite_count + 1)
        self.total_notfinite = torch.where(finite, self.total_notfinite, self.total_notfinite + 1)
        apply = finite | (self.notfinite_count > self.max_consecutive_errors)
        self.count = torch.where(apply, count_inc, self.count)
        new = torch._foreach_add(self.params, update)
        for i, p in enumerate(self.params):
            p.copy_(torch.where(apply, new[i], p))
        self.mu = [torch.where(apply, m, m0) for m, m0 in zip(mu, self.mu)]
        self.nu = [torch.where(apply, v, v0) for v, v0 in zip(nu, self.nu)]

    def state_dict(self):
        return {"count": self.count, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite, "mu": list(self.mu),
                "nu": list(self.nu)}

    def load_state_dict(self, state):
        dev = self.count.device
        for key in ("count", "notfinite_count", "total_notfinite"):
            setattr(self, key, state[key].to(dev))
        self.mu = [m.to(dev) for m in state["mu"]]
        self.nu = [v.to(dev) for v in state["nu"]]


def make_refiner_train_state(net, seed, input_size=160, c_in=6, lr=1e-4):
    """``net`` with flax-style initial parameters drawn from ``seed``
    (``convert.flax_init``) and an ``Optimizer`` that is ``optax.adam(lr)``.
    One forward on zeros of (1, input_size, input_size, c_in) checks that the
    net takes such crops, as the JAX package's ``net.init`` traces them.
    Returns (net, optimiser)."""
    from foundationpose_tpu_torch.models import convert

    convert.flax_init(net, seed)
    z = torch.zeros((1, input_size, input_size, c_in), device=next(net.parameters()).device)
    with torch.no_grad():
        net(z, z)
    return net, Optimizer(net.parameters(), lr)


# ---------------------------------------------------------------------------
# train steps: forward, backward, one update; the loss stays on the device


def _step(net, opt, loss_fn, mesh=None):
    """One update. With a ``mesh`` (``parallel.mesh.Mesh``, first axis) the
    step is data-parallel, as the JAX package's jitted step is on a sharded
    batch: each process passes its equal slice of the global batch, its loss
    (a mean over the slice) is divided by the axis size so that the SUM over
    processes is the mean over the global batch, and the gradients are summed
    over the processes (``all_reduce_grads``) BEFORE the optimiser, whose clip
    and non-finite test must see the global gradient (per-process ones would
    clip otherwise, and a per-process skip would part the replicas for good).
    Returns the global loss on every process."""
    for p in opt.params:
        p.grad = None
    loss = loss_fn()
    if mesh is not None:
        from foundationpose_tpu_torch.parallel.mesh import all_reduce_grads, all_sum

        axis = mesh.axis_names[0]
        loss = loss / mesh.size(axis)
        loss.backward()
        all_reduce_grads(mesh, opt.params, axis)
        loss = all_sum(mesh, loss.detach(), axis)
    else:
        loss.backward()
    opt.step()
    return loss.detach()


def refiner_train_step(net, opt, batch, mesh_diameter=0.2, mesh=None):
    """One RefineNet update on ``batch``; with ``mesh``, this process's slice
    of a data-parallel step (``_step``; ``datagen.make_refine_batch(mesh=)``
    makes the slice)."""
    return _step(net, opt, lambda: refiner_loss(net, batch, mesh_diameter), mesh)


def refiner_train_step_multimesh(net, opt, batch, mesh_diameter, mesh=None):
    """``refiner_train_step`` for the corpus trainer, whose mesh changes every
    step: ``mesh_diameter`` is a 0-d tensor on the device (the corpus's
    diameters are uploaded once), so choosing a mesh reads nothing back."""
    return _step(net, opt, lambda: refiner_loss(net, batch, mesh_diameter), mesh)


def scorer_train_step(net, opt, batch, mode="listwise"):
    return _step(net, opt, lambda: scorer_loss(net, batch, mode=mode))
