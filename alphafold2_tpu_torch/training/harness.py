"""The train step (counterpart of the single-device `make_train_step` of
alphafold2_tpu/training/harness.py): distogram pretraining by default,
end-to-end structure training with an `E2EConfig` and
`training/e2e.py e2e_loss_fn`.

The JAX step is one jitted program: a `lax.scan` over microbatches, their
gradients, one optax update. Here `make_train_step` is a Python loop of
eager forward and backward passes, then one update (`step_body`); on the
card `training/executable.py CapturedTrainStep` captures the same body as
a CUDA graph, the counterpart of the jit (not the e2e step, whose
geometry reads the host: it runs eagerly on the card too):

  * each leaf's `.grad` is a static buffer (`train_state`), zeroed at the
    start of a step; autograd accumulates the microbatch gradients into it
    in place, and it is divided by their count. The loss and the gradients
    are the mean over microbatches; a leaf the forward does not read (the
    MSA stream's, in sequence-only training) keeps a zero gradient, as
    `jax.grad` gives it;
  * `grad_norm` is the global norm of the mean gradient, before clipping;
  * the update is optax's `chain(clip_by_global_norm(max_norm),
    adamw(schedule, weight_decay))`: the clip scales by max_norm / |g| only
    when |g| >= max_norm (not `torch.nn.utils.clip_grad_norm_`, which
    divides by |g| + 1e-6); then `torch.optim.AdamW`, whose bias
    correction, eps placement and decoupled weight decay are optax's, at
    the learning rate the schedule gives for the update count from 0 (a
    warmup from 0 gives lr 0 on the first step). On the card AdamW is
    `capturable` and its lr a device tensor, filled before each step, so a
    graph can hold the update; the CPU keeps a float lr (the same
    function, computed in double on the host);
  * the batch is copied to the device once a step, before the loop.

`with_fault_injection` wraps a step with the chaos hooks; checkpoints
and recovery are `training/checkpoint.py` and `training/resilience.py`.
Not ported: the multi-device accumulation step (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from alphafold2_tpu_torch.device import as_device_tensor, resolve_device, tree_leaves
from alphafold2_tpu_torch.models.alphafold2 import alphafold2_apply, alphafold2_init
from alphafold2_tpu_torch.models.config import Alphafold2Config
from alphafold2_tpu_torch.ops.quant import reject_quant_training
from alphafold2_tpu_torch.training.losses import (
    bucketed_distance_matrix,
    distogram_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    grad_accum: int = 16
    max_grad_norm: Optional[float] = None  # None or <= 0: no clipping
    weight_decay: float = 0.0
    # warmup_steps ramps linearly 0 -> lr; decay_steps (if set) then
    # cosine-decays to lr * decay_floor over that many post-warmup steps
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    decay_floor: float = 0.0


def _linear(count, steps, init, end):
    """optax.linear_schedule: init -> end over `steps` updates, then held."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def _cosine(count, steps, init, alpha):
    """optax.cosine_decay_schedule: init -> init * alpha over `steps`."""
    c = min(count, steps)
    return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / steps)) + alpha)


def make_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """lr(count) for the update count from 0, with optax's four branches:
    constant; warmup then hold; cosine decay alone; warmup then cosine."""
    lr, warm, decay = tcfg.learning_rate, tcfg.warmup_steps, tcfg.decay_steps
    if decay is not None and not decay > 0:
        raise ValueError(f"decay_steps must be positive, got {decay}")
    if warm == 0 and decay is None:
        return lambda count: lr
    if decay is None:
        return lambda count: _linear(count, warm, 0.0, lr)
    if warm == 0:
        return lambda count: _cosine(count, decay, lr, tcfg.decay_floor)
    alpha = 0.0 if lr == 0.0 else (lr * tcfg.decay_floor) / lr
    return lambda count: (_linear(count, warm, 0.0, lr) if count < warm
                          else _cosine(count - warm, decay, lr, alpha))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


class ClippedAdamW:
    """optax `chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay))` over a list of leaves whose `.grad` holds the
    gradient. On CUDA leaves AdamW is `capturable` (its step count on the
    card) and takes its lr from a device tensor (`set_lr`)."""

    def __init__(self, leaves, tcfg: TrainConfig):
        self.leaves = list(leaves)
        self.schedule = make_schedule(tcfg)
        norm = tcfg.max_grad_norm
        self.max_norm = norm if norm is not None and norm > 0 else math.inf
        device = self.leaves[0].device if self.leaves else torch.device("cpu")
        capturable = device.type == "cuda"
        lr = torch.zeros((), dtype=torch.float32, device=device) if capturable else 0.0
        self.adamw = torch.optim.AdamW(
            self.leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=tcfg.weight_decay, capturable=capturable,
        )

    def init_state(self) -> None:
        """Make AdamW's per-leaf state (step 0, zero moments) where it has
        not made it yet, as its first step would: a restore or a rollback
        then copies into tensors that exist."""
        for group in self.adamw.param_groups:
            for p in group["params"]:
                st = self.adamw.state[p]
                if st:
                    continue
                if group["capturable"]:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                else:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def state_tensors(self) -> list:
        """Every tensor a step updates in place: the leaves, then each
        leaf's AdamW step, exp_avg and exp_avg_sq (made first where
        missing)."""
        self.init_state()
        out = list(self.leaves)
        for p in self.leaves:
            st = self.adamw.state[p]
            out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
        return out

    def set_lr(self, count: int) -> None:
        """lr = schedule(count): filled into the device tensor on the card
        (a launch, no copy from the host), a float on the CPU."""
        lr = self.schedule(count)
        for group in self.adamw.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def update(self) -> torch.Tensor:
        """Clip the leaves' gradients, then one AdamW update at the lr last
        set. Returns the global norm before clipping."""
        grads = [p.grad for p in self.leaves]
        norm = global_norm(grads)
        if self.max_norm != math.inf:
            keep = norm < self.max_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        self.adamw.step()
        return norm

    def step(self, count: int) -> torch.Tensor:
        """`set_lr(count)`, then `update()`."""
        self.set_lr(count)
        return self.update()


def make_optimizer(tcfg: TrainConfig, leaves) -> ClippedAdamW:
    return ClippedAdamW(leaves, tcfg)


def train_state(params, tcfg: TrainConfig) -> dict:
    """The train state of a parameter tree: the tree (its leaves now
    require grad, each with a zeroed `.grad` buffer that every step
    accumulates into), the optimizer over its leaves, and the update
    count."""
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
        t.grad = torch.zeros_like(t)
    return {"params": params, "optimizer": make_optimizer(tcfg, leaves), "step": 0}


def train_state_init(cfg: Alphafold2Config, tcfg: TrainConfig,
                     generator: torch.Generator, device=None) -> dict:
    """Fresh parameters from `generator` (a CPU generator) on `device`
    (default CUDA; device="cpu" for the CPU) and their train state. An
    int8 config is refused (inference-only)."""
    reject_quant_training(cfg, "train_state_init")
    return train_state(alphafold2_init(cfg, generator, resolve_device(device)), tcfg)


def make_distogram_loss_fn(apply_fn):
    """The distogram pretraining loss around any model apply function with
    the alphafold2_apply signature. batch: {"seq": (b, L) int, "mask":
    (b, L) bool, "coords": (b, L, 3)} (+ optional "msa", "msa_mask"), numpy
    arrays or tensors."""

    def loss_fn(params, cfg: Alphafold2Config, batch, rng=None, device=None):
        dev = resolve_device(device)
        mask = as_device_tensor(batch["mask"], dev, torch.bool)
        labels = bucketed_distance_matrix(
            as_device_tensor(batch["coords"], dev, torch.float32), mask
        )
        logits = apply_fn(
            params, cfg, batch["seq"], batch.get("msa"), mask=mask,
            msa_mask=batch.get("msa_mask"), rng=rng, device=dev,
        )
        return distogram_cross_entropy(logits, labels)

    return loss_fn


distogram_loss_fn = make_distogram_loss_fn(alphafold2_apply)


def check_train_config(cfg, device: torch.device, what: str) -> None:
    """Refuse what no train step takes: an int8 config (inference-only), and
    a sparse config with attention dropout on the card (the sparse kernels
    have no dropout). cfg: an Alphafold2Config, or an E2EConfig whose
    model config is checked."""
    model = getattr(cfg, "model", cfg)
    reject_quant_training(model, what)
    if device.type == "cuda" and any(model.layer_sparse) and model.attn_dropout > 0.0:
        raise ValueError(
            f"{what}: sparse_self_attn with attn_dropout={model.attn_dropout} on {device}: "
            f"the sparse CUDA kernels have no attention dropout; set attn_dropout=0")


def check_microbatches(batch, tcfg: TrainConfig) -> None:
    sizes = {len(v) for v in batch.values()}
    if sizes != {tcfg.grad_accum}:
        raise ValueError(f"batch leaves must lead with grad_accum={tcfg.grad_accum} "
                         f"microbatches, got {sizes}")


def step_body(state, cfg, batch, loss_fn, rng, device):
    """One step's work on a batch whose leaves already lie on `device` and
    lead with the microbatch axis, at the lr already set (cfg: whatever
    `loss_fn` takes, an Alphafold2Config or an E2EConfig): zero the
    gradient buffers, accumulate each microbatch's gradient into them,
    divide by the count, clip and update. Returns the mean loss and the
    global norm before clipping (0-d device tensors). The eager step and
    the captured one run this same sequence of ops."""
    opt = state["optimizer"]
    grads = [p.grad for p in opt.leaves]
    torch._foreach_zero_(grads)
    n = len(next(iter(batch.values())))
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    for index in range(n):
        loss = loss_fn(state["params"], cfg, {k: v[index] for k, v in batch.items()},
                       rng, device)
        loss.backward()
        loss_sum += loss.detach()
    torch._foreach_div_(grads, n)
    return loss_sum / n, opt.update()


def make_train_step(cfg, tcfg: TrainConfig,
                    loss_fn: Callable[..., Any] = distogram_loss_fn, device=None):
    """`train_step(state, batch, rng=None) -> (state, metrics)`, eager.
    cfg: an Alphafold2Config (the distogram loss), or an E2EConfig with
    `loss_fn=training/e2e.py e2e_loss_fn` (its train state from
    `e2e_train_state_init`). batch leaves carry a leading microbatch axis
    of length tcfg.grad_accum;
    rng is an optional CPU generator for dropout. The state is updated in
    place and returned; metrics are 0-d tensors on the device: "loss" (the
    microbatch mean) and "grad_norm" (of the mean gradient, before
    clipping). An int8 config is refused (inference-only), and so is a
    sparse config with attention dropout on the card (the sparse kernels
    have no dropout). On the card `CapturedTrainStep` replays this step
    as a CUDA graph."""
    dev = resolve_device(device)
    check_train_config(cfg, dev, "make_train_step")

    def train_step(state, batch, rng=None):
        check_microbatches(batch, tcfg)
        state["optimizer"].set_lr(state["step"])
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grad_norm = step_body(state, cfg, batch, loss_fn, rng, dev)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return train_step


def with_fault_injection(step_fn, injector):
    """Wrap a step function with the chaos hooks (reliability/faults.py),
    host-side around the step: before it the injector may raise
    (step_exception) or trip a preemption; after it a nan_grads fault
    poisons the reported metrics, which `StepGuard` must roll back.
    `injector=None` returns `step_fn` unchanged."""
    if injector is None:
        return step_fn

    def wrapped(state, batch, rng=None):
        step = int(state["step"])
        batch = injector.before_train_step(step, batch)
        new_state, metrics = step_fn(state, batch, rng)
        return injector.after_train_step(step, new_state, metrics)

    return wrapped


def add_train_args(ap):
    """The optimizer/schedule/seed argparse block of the JAX trainers."""
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for params, data, and per-step rng")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear lr warmup steps (0 = constant lr)")
    ap.add_argument("--decay-steps", type=int, default=None,
                    help="cosine-decay the lr over this many post-warmup steps")
    ap.add_argument("--decay-floor", type=float, default=0.0,
                    help="cosine decay ends at lr * this fraction")
    ap.add_argument("--max-grad-norm", type=float, default=None,
                    help="global-norm gradient clipping (<=0 or unset: off)")
    ap.add_argument("--weight-decay", type=float, default=0.0,
                    help="AdamW weight decay (default 0 = plain Adam)")


def tcfg_from_args(args, grad_accum: int) -> TrainConfig:
    return TrainConfig(
        learning_rate=args.lr,
        grad_accum=grad_accum,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
        decay_floor=args.decay_floor,
        max_grad_norm=args.max_grad_norm,
        weight_decay=args.weight_decay,
    )
