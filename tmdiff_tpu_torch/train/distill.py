"""Progressive distillation (port of tmdiff_tpu/train/distill.py): an N-step
deterministic (DDIM) student learns to land in ONE jump where TWO jumps of a
2N-step teacher land (Salimans & Ho, "Progressive Distillation for Fast
Sampling of Diffusion Models", ICLR 2022); each phase halves the sampler's
calls.

  * student grid: model times t_i = i T / N, i in [1, N]; T % 2N == 0 keeps
    the teacher's half-jumps on integer times;
  * target: the teacher jumps t -> t - T/2N -> t - T/N (`ddim_jump`), and
    the one-jump equation is solved for the x0 the student must predict,

        x0~ = (x_t'' - (sigma_t'' / sigma_t) x_t) / (alpha_t'' - (sigma_t'' / sigma_t) alpha_t)

    (`progressive_target`);
  * loss: max(alpha^2 / sigma^2, 1) |x0_hat - x0~| (or its square), the
    student in train mode (dropout on), the teacher's two calls without
    autograd and without dropout, with the teacher's weights passed per
    call (`train_step(state, batch, prompt, teacher_params)`).

The student index i and the noise come from the step's t-and-noise
generator (`Trainer.generators`), in that order, and the dropout masks from
its dropout generators, as the training step's; `loss` also takes i and the
noise, so that a test can hand it the JAX package's draws. `compiled_step`
is the Trainer's, with the teacher's weights as its static `extra`. Every 3x3x3 conv
of the three model calls runs K1 on the card: the teacher's forwards, the
student's forward and its input gradient.

On the trainer's mesh (train/trainer.py) i and the noise are drawn at the
global batch and sharded, the teacher's targets are computed on this rank's
shard, and the loss is this rank's share, as in the training step.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.train.trainer import Trainer, dropout_rngs


def progressive_target(ns: NoiseSchedule, x_t, x_t2, t, t2):
    """The x0 a one-jump student must predict to land on x_t2 from x_t:
    one DDIM jump t -> t2 solved for x0. t (B,) integers >= 1, t2 (B,)
    integers >= 0; the denominator is positive."""
    a_t, a_2 = gaussian.alpha_at(ns, t, x_t), gaussian.alpha_at(ns, t2, x_t)
    sigma = lambda au: torch.sqrt(torch.clamp(1.0 - au * au, min=0.0))
    ratio = sigma(a_2) / torch.clamp(sigma(a_t), min=1e-12)
    return (x_t2 - ratio * x_t) / (a_2 - ratio * a_t)


@dataclasses.dataclass
class DistillTrainer(Trainer):
    """A Trainer whose loss is the progressive-distillation objective.
    `n_student_steps` is this phase's N; the teacher is a model that can
    take 2N steps (the original model, or the previous phase's student)."""

    n_student_steps: int = 5
    snr_weight: bool = True  # max(SNR, 1), the paper's weighting for x-prediction

    def __post_init__(self):
        T, N = self.schedule.num_timesteps, self.n_student_steps
        if T % (2 * N):
            raise ValueError(f"T={T} must be divisible by 2·N={2 * N} so teacher "
                             "half-jumps stay on integer model times")
        super().__post_init__()

    def teacher_target(self, batch: dict, prompt_emb, teacher_params, i, noise):
        """(x_t, t, target, weight) of a batch: the student's input at
        t = i T / N, the teacher's two half-jumps solved for the one-jump x0
        target (without autograd), and the per-sample loss weight (1 without
        `snr_weight`). `teacher_params`: every parameter name of the model
        -> a tensor on its device (not the model's own tensors, which the
        step updates)."""
        ns = self.schedule
        seg = ns.num_timesteps // self.n_student_steps
        res, pan, ms = batch["Res"], batch["PAN"], batch["MS"]
        t = i * seg
        t1, t2 = t - seg // 2, t - seg
        a_t = gaussian.alpha_at(ns, t, res)
        x_t = gaussian.q_sample(res, a_t, noise)
        with torch.no_grad():
            def teacher(x, u):
                out = torch.func.functional_call(self.model, teacher_params,
                                                 (x, u, pan, ms, prompt_emb), strict=True)
                return gaussian.clip_x0(out, "static")

            x_t1 = gaussian.ddim_jump(ns, x_t, teacher(x_t, t), t, t1)
            x_t2 = gaussian.ddim_jump(ns, x_t1, teacher(x_t1, t1), t1, t2)
            target = progressive_target(ns, x_t, x_t2, t, t2)
        w = 1.0
        if self.snr_weight:
            w = torch.clamp(a_t * a_t / torch.clamp(1.0 - a_t * a_t, min=1e-12), min=1.0)
        return x_t, t, target, w

    def loss(self, step: int, batch: dict, prompt_emb, teacher_params, *, i=None, noise=None,
             gens=None):
        """The distillation loss of `batch` (the global batch) at step
        `step` (see `teacher_target` for `teacher_params`); i (B,) in [1, N]
        and the noise (at the global batch) are drawn unless given. On a
        mesh, this rank's share of the loss. `gens`: the generators, already
        seeded (`generators(step)` when None)."""
        gens = self.generators(step) if gens is None else gens
        model, device = self.model, self.device
        res = batch["Res"]
        gen = gens["tn"]
        if i is None:
            i = torch.randint(1, self.n_student_steps + 1, (res.shape[0],), generator=gen,
                              device=device)
        if noise is None:
            noise = torch.randn(res.shape, generator=gen, device=device, dtype=res.dtype)
        mesh, shard, batch, prompt_emb = self.place(batch, prompt_emb)
        x_t, t, target, w = self.teacher_target(batch, prompt_emb, teacher_params, shard(i),
                                                shard(noise))

        dropout_rng = dropout_rngs(gens)

        def student(x, u, pan, ms, emb):
            return model(x, u, pan, ms, emb, train=True, rng=dropout_rng())

        args = (x_t, t, batch["PAN"], batch["MS"], prompt_emb)
        if self.remat:
            x0_hat = checkpoint(student, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x0_hat = student(*args)
        err = (x0_hat - target).abs() if self.loss_type == "l1" else (x0_hat - target) ** 2
        loss = torch.mean(w * err)
        return loss if mesh is None else loss / mesh.size
