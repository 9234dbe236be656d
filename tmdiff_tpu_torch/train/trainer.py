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
recomputed in the backward pass (torch.utils.checkpoint); the recompute
draws its dropout masks from a second generator seeded as the first, so it
draws the same masks.

`compiled_step()` is the JAX trainer's jitted step: on a CUDA model it
captures the whole step (loss, backward, clip, AdamW, EMA) as one CUDA graph
per shape and replays it. So the step reads nothing from the host that
changes between steps: the trainer owns its generators and seeds them
before each step (a replay draws from the seeds set before it), AdamW is
`capturable` with its lr in a device tensor that the schedule fills after
each step, and the EMA factor is a device tensor filled before each step.
`train_step` runs the same step eagerly, with the same arithmetic, so the
two give the same state bit for bit and may be mixed on one state. On an
NCCL mesh each rank captures its own step with its collectives inside the
graph (the halo exchanges of the forward and backward, the gradient
all-reduce), as JAX compiles one SPMD program of the step; the ranks agree
before every call whether it captures, so that all of them capture at the
same call and replay the same collectives in one order.

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

Spans of a `compiled_step` call (utils/profiling.py, while its recorder is
on): `step.copy_in` (the arguments into the static inputs), `step.begin`
(the EMA factor, the generators seeded), on a card `step.capture` (the
eager step and the capture; `key` = the batch shapes) or `step.replay`
(the replay and the copy of its outputs), then `step.end` (the schedule
and the step count). None is recorded inside the step itself: it runs in
a capture.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.parallel import mesh as mesh_lib
from tmdiff_tpu_torch.train.ema import ema_factor, ema_update
from tmdiff_tpu_torch.utils import profiling

BATCH_KEYS = ("Res", "PAN", "MS")
# the trainer's generators: t and noise, the model call's dropout masks, its
# recompute's (seeded as the model call's) and the CFG coin
GENERATORS = ("tn", "drop", "drop_re", "cfg")


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
        `sd`; returns it. The optimiser keeps its own settings where they
        differ by device (`capturable`, an lr held in a device tensor) and
        the tensors it already holds, so a step captured on this state
        (Trainer.compiled_step) stays valid, and a state saved on one
        device loads on another."""
        self.model.load_state_dict(sd["model"], strict=True)
        _load_optimizer(self.optimizer, sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        if len(sd["ema_params"]) != len(self.ema_params):
            raise ValueError(f"{len(sd['ema_params'])} EMA tensors for {len(self.ema_params)} "
                             "parameters")
        with torch.no_grad():
            for e, v in zip(self.ema_params, sd["ema_params"]):
                e.copy_(v)
        self.step = int(sd["step"])
        return self


def dropout_rngs(gens: dict):
    """The dropout generator of each call of a step's model function, in
    turn: "drop" for the first, "drop_re" for remat's recompute."""
    order = iter((gens["drop"], gens["drop_re"]))
    return lambda: next(order)


def _load_optimizer(opt: torch.optim.Optimizer, sd: dict) -> None:
    """`opt.load_state_dict(sd)` that keeps, per group, the lr tensor and
    the `capturable` flag `opt` had (the tensor takes the saved value), and
    copies the saved moments and step counts into the tensors `opt` already
    holds; new ones go where `capturable` wants them (the step counts on the
    parameter's device, else on the host)."""
    groups = [(g["lr"], g["capturable"]) for g in opt.param_groups]
    held = {p: dict(st) for p, st in opt.state.items()}
    # the optimiser would keep the given tensors themselves
    opt.load_state_dict(copy.deepcopy(sd))
    for g, (lr, capturable) in zip(opt.param_groups, groups):
        if torch.is_tensor(lr):
            lr.fill_(float(g["lr"]))
            g["lr"] = lr
        else:
            g["lr"] = float(g["lr"])
        g["capturable"] = capturable
        for p in g["params"]:
            st = opt.state.get(p)
            if not st:
                continue
            step = st["step"].to(torch.float32)
            st["step"] = step.to(p.device) if capturable else step.cpu()
            for k, old in held.get(p, {}).items():
                new = st.get(k)
                if (torch.is_tensor(new) and new.shape == old.shape and new.dtype == old.dtype
                        and new.device == old.device):
                    st[k] = old.copy_(new)


@dataclasses.dataclass
class _Captured:
    """One shape's captured step: its static inputs (the call copies its
    arguments into them), the graph (None on the CPU, and until the first
    call has run), its outputs, the pointers of the state's tensors it was
    made on (`Trainer._fingerprint`) and the capture's host seconds."""

    batch: dict
    prompt: torch.Tensor
    extra: tuple
    graph: Any = None
    loss: Any = None
    grad_norm: Any = None
    fingerprint: tuple = ()
    capture_s: float = 0.0


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
        # device values a step reads, set on the host before it
        self._ema_factor = torch.zeros((), dtype=torch.float32, device=self.device)
        self._gens = {k: torch.Generator(device=self.device) for k in GENERATORS}
        # compiled_step's captured steps by shape, their memory pool and stream
        self._captured: dict = {}
        self._pool = self._stream = None

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
        # on a card AdamW reads its lr from a device tensor (capturable), so
        # that a captured step takes the schedule's value at each replay
        cuda = self.device.type == "cuda"
        lr = torch.tensor(self.lr, dtype=torch.float32, device=self.device) if cuda else self.lr
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay, capturable=cuda)
        for g in opt.param_groups:  # the schedule's base: a float, whatever holds the lr
            g["initial_lr"] = float(self.lr)
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

    def generators(self, step: int) -> dict:
        """The trainer's generators (GENERATORS) seeded for step `step`
        (`step_seeds`; "drop_re" as "drop"), on the model's device. A
        step's draws come from these; seeding them is host work, done
        before a step, never inside a captured one."""
        seed_tn, seed_drop, seed_cfg = step_seeds(self.seed, step)
        for name, s in zip(GENERATORS, (seed_tn, seed_drop, seed_drop, seed_cfg)):
            self._gens[name].manual_seed(s)
        return self._gens

    def loss(self, step: int, batch: dict, prompt_emb, *, t=None, noise=None, gens=None):
        """The training loss of `batch` (the global batch, tensors on the
        model's device) with step `step`'s randomness, dropout on; t and
        noise as in gaussian.diffusion_loss, at the global batch. On a mesh,
        this rank's share of the loss (module doc). `gens`: the generators,
        already seeded (`generators(step)` when None)."""
        gens = self.generators(step) if gens is None else gens
        model, device = self.model, self.device
        res_shape = tuple(batch["Res"].shape)
        mesh, shard, batch, prompt_emb = self.place(batch, prompt_emb)
        dropout_rng = dropout_rngs(gens)

        def apply(x, t, pan, ms, emb):
            return model(x, t, pan, ms, emb, train=True, rng=dropout_rng())

        def denoise(x, t, pan, ms):
            if self.remat:
                return checkpoint(apply, x, t, pan, ms, prompt_emb, use_reentrant=False,
                                  preserve_rng_state=False)
            return apply(x, t, pan, ms, prompt_emb)

        ms = batch["MS"]
        if self.p_uncond > 0.0:
            ms = gaussian.cfg_dropout_condition(gens["cfg"], ms, self.p_uncond, per_sample=True,
                                                mesh=mesh)
        gen = gens["tn"]
        if t is None:
            t = torch.randint(1, self.schedule.num_timesteps + 1, (res_shape[0],), generator=gen,
                              device=device)
        if noise is None:
            noise = torch.randn(res_shape, generator=gen, device=device)
        loss = gaussian.diffusion_loss(denoise, self.schedule, None, batch["Res"], batch["PAN"],
                                       ms, self.loss_type, t=shard(t), noise=shard(noise))
        return loss if mesh is None else loss / mesh.size

    def _begin(self, state: TrainState) -> dict:
        """The host's work before a step: the EMA factor of the step count
        it makes, and the generators seeded; returns them."""
        self._ema_factor.fill_(float(ema_factor(state.step + 1, self.ema_decay, self.ema_start)))
        return self.generators(state.step)

    def _step(self, state: TrainState, batch: dict, prompt_emb, extra, gens, draws):
        """The device work of one step: the loss and its gradients, their
        all-reduce on a mesh, the norm (and clip), AdamW at the lr its group
        holds and the EMA at `_ema_factor`. Returns (loss, norm), 0-d device
        tensors. It reads no host value that changes from step to step, so
        a capture of it replays any step."""
        state.optimizer.zero_grad(set_to_none=True)
        # profiler ranges (chip_smoke.py's step breakdown reads them)
        with torch.profiler.record_function("train.loss"):
            loss = self.loss(state.step, batch, prompt_emb, *extra, gens=gens, **draws)
        loss.backward()
        with torch.profiler.record_function("train.optimizer"):
            loss = self.all_reduce_grads(state, loss.detach())
            grad_norm = self._update(state)
        return loss, grad_norm

    def _end(self, state: TrainState, loss, grad_norm) -> dict:
        """The host's work after a step: the schedule (it fills the next
        step's lr) and the step count; returns the step's metrics."""
        lr = self.lr_fn(state.step)
        state.scheduler.step()
        state.step += 1
        return {"l_pix": loss, "lr": lr, "grad_norm": grad_norm}

    def _inputs(self, batch: dict, prompt_emb):
        return ({k: torch.as_tensor(batch[k], dtype=torch.float32, device=self.device)
                 for k in BATCH_KEYS},
                torch.as_tensor(prompt_emb, dtype=torch.float32, device=self.device))

    def train_step(self, state: TrainState, batch: dict, prompt_emb, *extra, **draws):
        """One optimisation step on `batch` ({"Res", "PAN", "MS"}: numpy
        arrays or tensors); returns (state, {"l_pix", "lr", "grad_norm"}),
        the loss and norm as 0-d device tensors (reading them waits for the
        step). `extra` goes to `loss` after the prompt (a subclass's
        operands, e.g. the distillation teacher's weights); `draws` (t and
        noise here) fix the step's draws (tests)."""
        batch, prompt_emb = self._inputs(batch, prompt_emb)
        gens = self._begin(state)
        loss, grad_norm = self._step(state, batch, prompt_emb, extra, gens, draws)
        return state, self._end(state, loss, grad_norm)

    def compiled_step(self):
        """The JAX trainer's compiled_step: a callable (state, batch,
        prompt_emb, *extra) -> (state, metrics) that runs one step, the one
        `train_step` runs, and updates `state` in place (JAX donates it).
        On a CUDA model each shape of the arguments (the batch's, the
        prompt's, `extra`'s tensors) gets one CUDA graph of the whole step,
        captured at the shape's first call after that call's own step has
        run eagerly, and replayed at every later call; the graphs share
        one memory pool. A call copies the batch, the prompt and `extra`
        into the graph's static inputs first, and copies the loss and norm
        out after, so its metrics outlive the next replay. A graph is
        captured again if the state's tensors are no longer the ones it
        was captured on (another state, a fresh optimiser). A capture that
        fails raises, after the call's own step; the step never falls back
        to running eagerly. On a CPU model the callable runs the same step
        without a capture. `release_compiled` frees the graphs. The
        parameters' `.grad` are the graph's buffers after a capturing call
        (which computes nothing in them) and the step's gradients after a
        replay.

        On a mesh of ranks every rank must make the same calls. Under NCCL
        each rank's graph holds its step's collectives; whether a call
        captures is put to every rank first (`Mesh.any`), so a shape or a
        state new on one rank makes all of them run the eager step and
        capture at that call (that vote is one host collective a call,
        counted in `mesh_lib.stats`). The eager step before a capture runs
        every collective of the step, so each communicator exists before
        the capture starts. NCCL's watchdog does not see a replayed
        collective: a rank that hangs in a replay is ended by its launcher
        (torchrun, `run_world`'s timeout), not by NCCL's timeout. A CPU mesh
        runs the step uncaptured. gloo on a card stages every collective
        through host memory, which a graph cannot hold: that mesh raises
        here."""
        mesh = self.mesh
        if (self.device.type == "cuda" and mesh is not None and mesh.size > 1
                and not mesh.capturable):
            raise ValueError(
                f"compiled_step on a mesh of {mesh.size} ranks needs NCCL: this mesh's "
                f"collectives run on {mesh.transport}, which a CUDA graph cannot hold; "
                "use train_step")
        return self._compiled

    def release_compiled(self) -> None:
        """Frees compiled_step's graphs, their static inputs and outputs and
        their memory pool; the gradients they left on the model go too."""
        self._captured.clear()
        self._pool = self._stream = None
        for p in self.model.parameters():
            p.grad = None

    def capture_seconds(self) -> dict:
        """The host seconds of each of compiled_step's captures, by the
        batch shapes of its key."""
        return {key[0]: c.capture_s for key, c in self._captured.items() if c.graph is not None}

    def _fingerprint(self, state: TrainState) -> tuple:
        """The pointers of every state tensor a captured step reads or
        writes in place: parameters, EMA, AdamW's moments, step counts and
        lr tensors."""
        ptrs = [t.data_ptr() for t in (*state.model.parameters(), *state.ema_params)]
        for g in state.optimizer.param_groups:
            ptrs.append(g["lr"].data_ptr() if torch.is_tensor(g["lr"]) else -1)
        for st in state.optimizer.state.values():
            ptrs += [v.data_ptr() for v in st.values() if torch.is_tensor(v)]
        return (id(state), *ptrs)

    def _compiled(self, state: TrainState, batch: dict, prompt_emb, *extra):
        batch = {k: torch.as_tensor(batch[k]) for k in BATCH_KEYS}
        prompt_emb = torch.as_tensor(prompt_emb)
        leaves, spec = pytree.tree_flatten(extra)
        key = (tuple(tuple(batch[k].shape) for k in BATCH_KEYS), tuple(prompt_emb.shape),
               str(spec), tuple((tuple(v.shape), v.dtype) if torch.is_tensor(v) else v
                                for v in leaves))
        entry = self._captured.get(key)
        fresh = entry is None or entry.fingerprint != self._fingerprint(state)
        if self.mesh is not None and self.mesh.size > 1:
            # a rank that captured while another replays would run other
            # collectives than its peers
            fresh = self.mesh.any(fresh)
        with profiling.span("step.copy_in"):
            if fresh:
                dev = lambda v: v.detach().to(self.device).clone() if torch.is_tensor(v) else v
                batch_dev, prompt_dev = self._inputs(batch, prompt_emb)
                entry = self._captured[key] = _Captured(
                    {k: v.clone() for k, v in batch_dev.items()}, prompt_dev.clone(),
                    tuple(pytree.tree_unflatten([dev(v) for v in leaves], spec)))
            else:
                for k in BATCH_KEYS:
                    entry.batch[k].copy_(batch[k])
                entry.prompt.copy_(prompt_emb)
                static = [v for v in pytree.tree_flatten(entry.extra)[0] if torch.is_tensor(v)]
                given = [v for v in leaves if torch.is_tensor(v)]
                if static:
                    torch._foreach_copy_(static, [v.to(self.device) for v in given])
        with profiling.span("step.begin"):
            gens = self._begin(state)
        if self.device.type != "cuda":
            loss, grad_norm = self._step(state, entry.batch, entry.prompt, entry.extra, gens, {})
        elif fresh:
            with profiling.span("step.capture", key=key[0]):
                loss, grad_norm = self._capture(state, entry, gens)
        else:
            with profiling.span("step.replay"):
                entry.graph.replay()
                loss, grad_norm = entry.loss.clone(), entry.grad_norm.clone()
        if fresh:
            entry.fingerprint = self._fingerprint(state)
        with profiling.span("step.end"):
            return state, self._end(state, loss, grad_norm)

    def _capture(self, state: TrainState, entry: _Captured, gens: dict):
        """The call's own step, eagerly (it also makes every lazy allocation
        and plan: AdamW's moments, the kernels' plans, cuBLAS and cuDNN
        state), then a capture of the step on the static inputs into the
        trainer's pool on a side stream. A capture runs nothing, so the
        state holds exactly the one step. Returns the eager step's (loss,
        norm)."""
        loss, grad_norm = self._step(state, entry.batch, entry.prompt, entry.extra, gens, {})
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in gens.values():
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            entry.loss, entry.grad_norm = self._step(state, entry.batch, entry.prompt,
                                                     entry.extra, gens, {})
        entry.graph, entry.capture_s = graph, time.perf_counter() - t0
        return loss, grad_norm

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

    def _update(self, state: TrainState):
        """The gradients into the state on the device: the global norm
        (clipped to grad_clip when set), AdamW, then the EMA at
        `_ema_factor`. Returns the norm before clipping."""
        params = list(state.model.parameters())
        if self.grad_clip:
            grad_norm = torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        else:
            grads = [p.grad for p in params if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        state.optimizer.step()
        ema_update(state.ema_params, params, factor=self._ema_factor)
        return grad_norm

    def apply_gradients(self, state: TrainState):
        """The parameters' `.grad` into the state: the global norm (clipped
        to grad_clip when set), an AdamW step at lr_fn(state.step), the step
        count, then the EMA at the new count. Returns the norm before
        clipping, a 0-d device tensor."""
        self._begin(state)
        grad_norm = self._update(state)
        self._end(state, None, grad_norm)
        return grad_norm
