"""Training step: the x0-prediction loss, AdamW with the HF "linear"
schedule, EMA (port of tmdiff_tpu/train/trainer.py), on one device or over
a ("data", "space") mesh of ranks.

Reference contract (`GeneralModel/model.py:14-47`): AdamW(lr,
weight_decay=1e-4) over every parameter, 100 warmup steps then a linear
decay to zero at max_iter, the L1 loss on the residual, one optimiser step
per batch. The prompt embeddings are precomputed constants, so the CLIP tower
never enters the parameters.

As in the JAX package, step k runs at lr_fn(k) (its first update at
lr_fn(0) = 0 under warmup), the EMA is updated after the optimiser with the
new step count, and all of a step's randomness derives from (seed, step):
t and the noise, the CFG coin and the dropout masks each come from a
torch.Generator on the model's device seeded from `step_seeds`, so a resumed
run repeats the steps it would have taken. Under `remat` the model call is
recomputed in the backward pass (torch.utils.checkpoint); the dropout
generator is created inside the recomputed function from the step's seed, so
the recompute draws the same masks.

Every 3x3x3 conv must take the "banded" lowering: its forward and input
gradient run K1 (ops/cuda/conv3d.py). "auto" is refused, since its 3x3
kernel has no backward. A model of dtype bfloat16 (WavBEST(dtype=...)) trains
as the JAX trainer's bf16 model does: bf16 compute, float32 parameters,
AdamW state and EMA (the loss is float32, the gradients reach the float32
parameters through their casts).

With a `mesh` (parallel/mesh.py) the step has the JAX trainer's semantics:
the batch is sharded (over "data", the height over "space", with the
fallback to replication), the parameters replicated. t, the noise and the
CFG coin are drawn at the global batch and sharded, as are the dropout
masks (models/blocks.py). Each rank's loss is its shard's mean divided by
the mesh size, i.e. its sum over the global element count times the
replication factor, so the losses summed over the world are the global
loss. The gradients (and the loss, for the metrics) are summed over the
world in one flat all-reduce before clipping; not DDP, since the space axis
needs the same sum and one collective a step serves both axes. AdamW, the
schedule and the EMA then run alike on every rank. In a world of more than
one rank the mesh defaults to every rank on "data", as the JAX trainer's to
every device.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.parallel import mesh as mesh_lib
from tmdiff_tpu_torch.train.ema import ema_update


def hf_linear_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """HF transformers get_scheduler("linear"): lr rises linearly from 0 over
    `warmup_steps`, then falls linearly to 0 at `total_steps`. In float64
    (the JAX package computes it in float32)."""

    def fn(step):
        warm = step / max(1.0, warmup_steps)
        decay = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        return base_lr * min(max(min(warm, decay), 0.0), 1.0)

    return fn


def step_seeds(seed: int, step: int) -> tuple[int, int, int]:
    """Seeds of a step's three streams (t and noise, dropout, CFG coin), the
    counterparts of the JAX trainer's fold_in(fold_in(key(seed), step), i)."""
    return tuple(int(s) for s in np.random.SeedSequence([seed, step]).generate_state(3, np.uint64))


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema_params: list  # one tensor per model parameter, in model.parameters() order

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors and Python scalars
        (references to the live tensors, not copies): the step, the model's
        weights, AdamW's moments and step counts, the schedule's position and
        the EMA."""
        return {"step": int(self.step), "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "ema_params": list(self.ema_params)}

    def load_state_dict(self, sd: dict) -> "TrainState":
        """Loads a `state_dict()` into this state in place (the model's and
        the EMA's tensors keep their devices) and shares no tensor with
        `sd`; returns it."""
        self.model.load_state_dict(sd["model"], strict=True)
        # the optimiser would keep the given moment tensors themselves
        self.optimizer.load_state_dict(copy.deepcopy(sd["optimizer"]))
        self.scheduler.load_state_dict(sd["scheduler"])
        if len(sd["ema_params"]) != len(self.ema_params):
            raise ValueError(f"{len(sd['ema_params'])} EMA tensors for {len(self.ema_params)} "
                             "parameters")
        with torch.no_grad():
            for e, v in zip(self.ema_params, sd["ema_params"]):
                e.copy_(v)
        self.step = int(sd["step"])
        return self


@dataclasses.dataclass
class Trainer:
    """Owns the optimiser settings and the step. `model` is a WavBEST (its
    parameters live on its device, and the state updates them in place)."""

    model: Any
    schedule: NoiseSchedule
    lr: float = 1e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    max_iter: int = 300_000
    loss_type: str = "l1"
    ema_decay: float = 0.9999
    ema_start: int = 0
    # clip_grad_norm_ divides by the norm + 1e-6; optax by the norm alone
    grad_clip: Optional[float] = None
    # per-sample probability of zeroing the MS conditioning (classifier-free
    # guidance training)
    p_uncond: float = 0.0
    seed: int = 3407
    # recompute the model call in the backward pass, as the JAX default
    remat: bool = True
    # the ("data", "space") mesh (parallel/mesh.py); None: one process
    mesh: Optional[Any] = None

    def __post_init__(self):
        if any(getattr(m, "impl", "banded") != "banded" for m in self.model.modules()):
            raise ValueError('the trainer needs the "banded" conv lowering: "auto" has no '
                             'backward (WavBEST.use_conv_impl("banded"))')
        if self.mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
            self.mesh = mesh_lib.make_mesh()
        self.lr_fn = hf_linear_schedule(self.lr, self.warmup_steps, self.max_iter)
        self.device = self.model.device
        self.schedule = self.schedule.to(self.device)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> TrainState:
        """State at step 0 from the model's current parameters, with a fresh
        optimiser and an EMA copy."""
        params = list(self.model.parameters())
        if self.mesh is not None and self.mesh.size > 1:
            with torch.no_grad():  # replicated: every rank starts from rank 0's weights
                flat = mesh_lib.broadcast_(torch.cat([p.reshape(-1) for p in params]), self.mesh)
                off = 0
                for p in params:
                    p.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()
        opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)
        factor = hf_linear_schedule(1.0, self.warmup_steps, self.max_iter)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
        return TrainState(step=0, model=self.model, optimizer=opt, scheduler=sched,
                          ema_params=[p.detach().clone() for p in params])

    def state_from_params(self, params) -> TrainState:
        """State at step 0 from existing parameters (a state_dict of the
        model, e.g. a teacher's): loaded strictly, then as init_state."""
        self.model.load_state_dict(params, strict=True)
        return self.init_state()

    # -- the step ------------------------------------------------------------

    def place(self, batch: dict, prompt_emb):
        """(the mesh placed for `batch`, or None; a function that shards a
        global tensor; the batch and prompt sharded). The model is set to
        the placement (WavBEST.use_mesh)."""
        mesh = None if self.mesh is None else self.mesh.place(tuple(batch["MS"].shape))
        self.model.use_mesh(mesh)
        shard = (lambda x: x) if mesh is None else mesh.shard
        batch = {k: shard(v) for k, v in batch.items()}
        if prompt_emb.dim() == 2:
            prompt_emb = shard(prompt_emb)
        return mesh, shard, batch, prompt_emb

    def loss(self, step: int, batch: dict, prompt_emb, *, t=None, noise=None):
        """The training loss of `batch` (the global batch, tensors on the
        model's device) with step `step`'s randomness, dropout on; t and
        noise as in gaussian.diffusion_loss, at the global batch. On a mesh,
        this rank's share of the loss (module doc)."""
        seed_tn, seed_drop, seed_cfg = step_seeds(self.seed, step)
        model, device = self.model, self.device
        res_shape = tuple(batch["Res"].shape)
        mesh, shard, batch, prompt_emb = self.place(batch, prompt_emb)

        def apply(x, t, pan, ms, emb):
            rng = torch.Generator(device=device).manual_seed(seed_drop)
            return model(x, t, pan, ms, emb, train=True, rng=rng)

        def denoise(x, t, pan, ms):
            if self.remat:
                return checkpoint(apply, x, t, pan, ms, prompt_emb, use_reentrant=False,
                                  preserve_rng_state=False)
            return apply(x, t, pan, ms, prompt_emb)

        ms = batch["MS"]
        if self.p_uncond > 0.0:
            gen = torch.Generator(device=device).manual_seed(seed_cfg)
            ms = gaussian.cfg_dropout_condition(gen, ms, self.p_uncond, per_sample=True,
                                                mesh=mesh)
        gen = torch.Generator(device=device).manual_seed(seed_tn)
        if t is None:
            t = torch.randint(1, self.schedule.num_timesteps + 1, (res_shape[0],), generator=gen,
                              device=device)
        if noise is None:
            noise = torch.randn(res_shape, generator=gen, device=device)
        loss = gaussian.diffusion_loss(denoise, self.schedule, None, batch["Res"], batch["PAN"],
                                       ms, self.loss_type, t=shard(t), noise=shard(noise))
        return loss if mesh is None else loss / mesh.size

    def train_step(self, state: TrainState, batch: dict, prompt_emb, *extra, **draws):
        """One optimisation step on `batch` ({"Res", "PAN", "MS"}: numpy
        arrays or tensors); returns (state, {"l_pix", "lr", "grad_norm"}),
        the loss and norm as 0-d device tensors (reading them waits for the
        step). `extra` goes to `loss` after the prompt (a subclass's
        operands, e.g. the distillation teacher's weights); `draws` (t and
        noise here) fix the step's draws (tests)."""
        dev = self.device
        batch = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
                 for k in ("Res", "PAN", "MS")}
        prompt_emb = torch.as_tensor(prompt_emb, dtype=torch.float32, device=dev)
        state.optimizer.zero_grad(set_to_none=True)
        # profiler ranges (chip_smoke.py's step breakdown reads them)
        with torch.profiler.record_function("train.loss"):
            loss = self.loss(state.step, batch, prompt_emb, *extra, **draws)
        loss.backward()
        lr = self.lr_fn(state.step)
        with torch.profiler.record_function("train.optimizer"):
            loss = self.all_reduce_grads(state, loss.detach())
            grad_norm = self.apply_gradients(state)
        return state, {"l_pix": loss, "lr": lr, "grad_norm": grad_norm}

    def all_reduce_grads(self, state: TrainState, loss):
        """On a mesh of more than one rank, every parameter's `.grad` and
        `loss` summed over the world in one flat all-reduce (a parameter
        without a gradient takes zeros); returns the summed loss. The loss
        itself without a mesh."""
        if self.mesh is None or self.mesh.size == 1:
            return loss
        params = list(state.model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params] + [loss.reshape(1)])
        mesh_lib.all_reduce_(flat, self.mesh)
        off = 0
        for p in params:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p)
            off += n
        return flat[off]

    def apply_gradients(self, state: TrainState):
        """The parameters' `.grad` into the state: the global norm (clipped
        to grad_clip when set), an AdamW step at lr_fn(state.step), the step
        count, then the EMA at the new count. Returns the norm before
        clipping, a 0-d device tensor."""
        params = list(state.model.parameters())
        if self.grad_clip:
            grad_norm = torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        else:
            grads = [p.grad for p in params if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        ema_update(state.ema_params, params, state.step, self.ema_decay, self.ema_start)
        return grad_norm
