"""Training step: the masked loss, its gradient, and optax's optimizer chain.

The counterpart of `codon_tpu.train.trainer`: one device here, and over a
dp x sp mesh of ranks through `parallel.train` (`make_train_step(...,
mesh=)`). The reference ships no training code; this trainer is the path
to the repo's weights.

The optimizer is written out on tensors, as the JAX package's optax chain
computes it:

  clip_by_global_norm  g if |g| < max, else g / |g| * max (not
                       `clip_grad_norm_`, which divides by |g| + 1e-6);
  scale_by_adam        b1 0.9, b2 0.999, eps 1e-8, eps_root 0, with bias
                       correction;
  add_decayed_weights  + weight_decay * p, after Adam and before the
                       learning rate (decoupled, AdamW);
  scale_by_learning_rate  * -lr(count), lr a warmup + cosine schedule, a
                       linear warmup, or a constant; the count starts at
                       0, so step 1 uses lr(0).

Its state is a plain dict, {"count", "mu", "nu"}, that the checkpoint
manager saves. Parameters are updated in place: the step returns the same
tensors it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from codon_tpu_torch.core.params import full_fp32

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    loss: str = "l1"               # "l1" | "l2"
    # > 0 adds grad_weight * the mean L1 error of the spatial forward
    # differences (pairs with both endpoints valid)
    grad_weight: float = 0.0
    clip_norm: Optional[float] = None
    weight_decay: float = 0.0
    # warmup_steps > 0: linear warmup from lr/100 to lr, then (with
    # total_steps) cosine decay to lr * end_lr_ratio at total_steps
    warmup_steps: int = 0
    total_steps: int = 0
    end_lr_ratio: float = 0.01


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


class CollapseDetector:
    """Dead-network detection: `patience` consecutive global gradient norms
    of exactly 0.0 (log steps apart) mean every path from the parameters to
    the output is closed, a dead-ReLU fixed point that cannot recover; a
    live norm, however small, resets the streak."""

    def __init__(self, patience: int = 3):
        self.patience = patience
        self.zero_streak = 0

    def update(self, grad_norm: float) -> bool:
        """Feed one observed global grad norm; True => training is dead."""
        if grad_norm == 0.0:
            self.zero_streak += 1
        else:
            self.zero_streak = 0
        return self.zero_streak >= self.patience


# ---------------------------------------------------------------------------
# parameter trees: nested dicts of tensors, leaves in sorted-key order
# ---------------------------------------------------------------------------

def tree_items(tree, prefix=""):
    """-> [(path, leaf)] of a nested dict, keys sorted as JAX flattens."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += tree_items(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def top_name(path: str) -> str:
    """A tree_items path's top-level parameter name: "cac/ch_w1" -> "cac",
    "attention_c5.mlp.1.weight" (a zoo net's flat key) -> "attention_c5"."""
    return path.split("/")[0].split(".")[0]


def tree_rebuild(tree, leaves):
    """The structure of `tree` with `leaves` (in tree_items order)."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return build(tree)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of every element's square, float32 (optax's)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in leaves))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _linear(init, end, steps, count):
    """optax.linear_schedule in float32."""
    f32 = np.float32
    c = min(max(count, 0), steps)
    frac = f32(1) - f32(c) / f32(steps)
    return (f32(init) - f32(end)) * frac + f32(end)


def make_schedule(cfg: TrainConfig):
    """count -> learning rate (float32), as `codon_tpu`'s make_optimizer
    builds it from optax's schedules."""
    lr = cfg.learning_rate
    f32 = np.float32
    if cfg.warmup_steps > 0 and cfg.total_steps > 0:
        w, peak, end = cfg.warmup_steps, lr, lr * cfg.end_lr_ratio
        decay_steps = cfg.total_steps - w
        if decay_steps <= 0:
            raise ValueError(f"total_steps {cfg.total_steps} must exceed "
                             f"warmup_steps {w}")
        alpha = f32(0.0 if peak == 0.0 else end / peak)

        def schedule(count):
            if count < w:
                return _linear(lr * 0.01, peak, w, count)
            c = f32(min(count - w, decay_steps))
            cos = f32(0.5) * (f32(1) + f32(np.cos(f32(np.pi) * c
                                                  / f32(decay_steps))))
            return f32(peak) * ((f32(1) - alpha) * cos + alpha)
        return schedule
    if cfg.warmup_steps > 0:
        return lambda count: _linear(lr * 0.01, lr, cfg.warmup_steps, count)
    return lambda count: f32(lr)


class Optimizer:
    """optax.chain(clip_by_global_norm?, scale_by_adam(),
    add_decayed_weights?, scale_by_learning_rate(schedule)) on lists of
    float32 tensors, in place (`torch._foreach_*`)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params) -> dict:
        zeros = [torch.zeros_like(p) for _, p in tree_items(params)]
        return {"count": 0, "mu": tree_rebuild(params, zeros),
                "nu": tree_rebuild(params, [z.clone() for z in zeros])}

    @torch.no_grad()
    def update(self, grads, state, params):
        """Apply one update to `params` (in place) from `grads` (a list in
        tree_items order) -> the new state."""
        cfg = self.cfg
        p = [t for _, t in tree_items(params)]
        mu = [t for _, t in tree_items(state["mu"])]
        nu = [t for _, t in tree_items(state["nu"])]
        g = list(grads)
        if cfg.clip_norm:
            # where(|g| < max, g, g / |g| * max), with no copy to the host
            norm = global_norm(g)
            keep = norm < cfg.clip_norm
            g = [torch.where(keep, t, t / norm * cfg.clip_norm) for t in g]
        count = int(state["count"]) + 1
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - ADAM_B2)
        f32 = np.float32
        bc1 = float(f32(1) - f32(ADAM_B1) ** count)
        bc2 = float(f32(1) - f32(ADAM_B2) ** count)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if cfg.weight_decay:
            torch._foreach_add_(upd, p, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -float(self.schedule(count - 1)))
        torch._foreach_add_(p, upd)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def loss_sums(out, batch, cfg: TrainConfig, below=None):
    """The sums `masked_loss` divides -> (error sum, valid pixels, the
    forward differences' error sum, valid pairs), float32 0-d tensors; the
    last two 0 without grad_weight. A pair along H or W counts when both
    its pixels are valid.

    below: None, or the first row of (out, label, mask) of the part of the
    image below this one, (N, 1, W, 3): its pairs with this part's last
    row count here (a spatial shard's; zero rows below the image drop the
    pairs)."""
    m = batch["mask"]
    lbl = batch["label"]
    err = (out - lbl) * m
    if cfg.loss == "l2":
        num = torch.sum(err * err)
    elif cfg.loss == "l1":
        num = torch.sum(torch.abs(err))
    else:
        raise ValueError(f"TrainConfig.loss must be 'l1' or 'l2', got "
                         f"{cfg.loss!r}")
    den = torch.sum(m)
    if not cfg.grad_weight:
        zero = num.new_zeros(())
        return num, den, zero, zero
    oh, lh, mh = out, lbl, m
    if below is not None:
        oh = torch.cat([out, below[..., :1]], 1)
        lh = torch.cat([lbl, below[..., 1:2]], 1)
        mh = torch.cat([m, below[..., 2:]], 1)
    my = mh[:, 1:] * mh[:, :-1]
    mx = m[:, :, 1:] * m[:, :, :-1]
    ey = ((oh[:, 1:] - oh[:, :-1]) - (lh[:, 1:] - lh[:, :-1])) * my
    ex = ((out[:, :, 1:] - out[:, :, :-1])
          - (lbl[:, :, 1:] - lbl[:, :, :-1])) * mx
    return (num, den, torch.sum(torch.abs(ey)) + torch.sum(torch.abs(ex)),
            torch.sum(my) + torch.sum(mx))


def loss_of_sums(cfg: TrainConfig, num, den, gnum, gden):
    """The masked loss from `loss_sums`' four sums (JAX's loss_fn):
    num / den, plus grad_weight x gnum / max(gden, 1)."""
    loss = num / den
    if cfg.grad_weight:
        loss = loss + cfg.grad_weight * (gnum / torch.clamp_min(gden, 1.0))
    return loss


def masked_loss(out, batch, cfg: TrainConfig) -> torch.Tensor:
    """The masked l1 / l2 loss, plus grad_weight x the masked L1 of the
    forward differences along H and W, float32 (JAX's loss_fn)."""
    return loss_of_sums(cfg, *loss_sums(out, batch, cfg))


class TrainStep:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    batch: {"depth", "color", "label", "mask"} tensors on the params'
    device. metrics: {"loss", "grad_norm"} 0-d float32 tensors on the
    device (grad_norm unclipped); reading them syncs. `ops`: an Ops
    backend (a fake-quant one for QAT). With check_finite, a NaN or inf in
    the loss or any gradient raises FloatingPointError before the update.
    The pieces are public for timing: `loss`, `value_and_grad`, `opt`.
    """

    def __init__(self, variant, cfg: TrainConfig, ops=None,
                 check_finite: bool = False):
        self.variant = variant
        self.cfg = cfg
        self.ops = ops
        self.check_finite = check_finite
        self.opt = make_optimizer(cfg)

    def loss(self, params, batch) -> torch.Tensor:
        out = self.variant.train_forward(params, batch["depth"],
                                         batch["color"], mask=batch["mask"],
                                         ops=self.ops)
        return masked_loss(out, batch, self.cfg)

    def _objective(self, params, batch):
        """-> (what to differentiate, what else the step needs from the
        forward): the loss and None here; a shard's part of the loss and
        its partial sums in `parallel.train`."""
        return self.loss(params, batch), None

    def _leaf_grads(self, params, batch):
        """-> (objective, aux, [grad of each leaf in tree_items order]). A
        leaf that the forward should reach but got no gradient raises: a
        cut graph would otherwise train only what lies behind the cut. The
        leaves under the variant's `unread` names get zeros, as JAX's
        gradient gives them."""
        items = tree_items(params)
        leaves = [t.detach().requires_grad_(True) for _, t in items]
        with torch.enable_grad(), full_fp32():
            objective, aux = self._objective(tree_rebuild(params, leaves),
                                             batch)
            grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        out = []
        for (path, t), g in zip(items, grads):
            if g is None:
                if top_name(path) not in self.variant.unread:
                    raise RuntimeError(
                        f"no gradient reached parameter {path!r}: the "
                        f"training forward's graph is cut")
                g = torch.zeros_like(t)
            out.append(g)
        return objective.detach(), aux, out

    def value_and_grad(self, params, batch):
        """-> (loss, [grad of each leaf in tree_items order]); see
        `_leaf_grads`."""
        loss, _, grads = self._leaf_grads(params, batch)
        return loss, grads

    def _check(self, params, loss, grads):
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"non-finite loss {float(loss)}")
        for (path, _), g in zip(tree_items(params), grads):
            if not bool(torch.isfinite(g).all()):
                raise FloatingPointError(
                    f"non-finite gradient of parameter {path!r}")

    def __call__(self, params, opt_state, batch):
        loss, grads = self.value_and_grad(params, batch)
        if self.check_finite:
            self._check(params, loss, grads)
        gnorm = global_norm(grads)
        opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}


def make_train_step(variant, cfg: TrainConfig = TrainConfig(), ops=None,
                    check_finite: bool = False, mesh=None):
    """-> (step, opt): `TrainStep` and its `Optimizer` (opt.init(params)
    makes the state), as `codon_tpu`'s make_train_step returns (step, tx).

    mesh: rank 0's handle of a dp x sp mesh (`parallel.MeshPool.mesh`):
    the step then runs over its ranks (`parallel.train.MeshTrainStep`, the
    same signature), the batch cut over dp and H over sp, the gradients
    summed over the mesh. `ops` there is None or a fake-quant backend,
    which maps to its sharded twin; any other backend raises
    NotImplementedError, as in JAX.
    """
    if mesh is not None:
        from codon_tpu_torch.parallel.train import MeshTrainStep
        step = MeshTrainStep(variant, cfg, mesh, ops=ops,
                             check_finite=check_finite)
        return step, step.opt
    step = TrainStep(variant, cfg, ops=ops, check_finite=check_finite)
    return step, step.opt


def ema_update(ema, params, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, leaf by leaf, in place."""
    with torch.no_grad():
        for (_, e), (_, p) in zip(tree_items(ema), tree_items(params)):
            e.copy_(decay * e + (1.0 - decay) * p)
