"""The optimizer of a config, the port of
``patchrefinerv2_tpu/training/optim.py`` (``_onecycle_phases`` :47,
``_onecycle_lr_schedule`` :64, ``_momentum_schedule`` :85,
``build_optimizer`` :104), step for step what its optax chain computes:

1. global-norm clipping as ``optax.clip_by_global_norm`` does it: with the
   norm ``n`` of all gradients, each becomes ``(g / n) * max_norm`` when
   ``n >= max_norm`` (no ``+ 1e-6`` as in ``clip_grad_norm_``);
2. AdamW (b2 0.999, eps 1e-8, decoupled decay on every parameter) with the
   OneCycle learning rate and, with ``cycle_momentum``, the cycled ``b1``,
   both evaluated at the step count before the update, as optax's
   ``inject_hyperparams`` does;
3. each parameter's update scaled by its ``paramwise_cfg.custom_keys``
   ``lr_mult`` (decay included), or by 0 under a frozen prefix.

The port's parameter names are the reference's torch names, so the config's
prefixes (``refiner_fine_branch.refiner_encoder``, ``coarse_branch``) match
them as they are. A parameter without a gradient is updated as with a zero
gradient (optax sees zeros there). The schedules are float32 arithmetic, as
in the JAX package.
"""

from __future__ import annotations

import math

import torch

__all__ = ["onecycle_lr_schedule", "momentum_schedule", "AdamW", "build_optimizer"]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _onecycle_phases(total_steps: int, pct_start: float):
    """torch OneCycleLR's float milestones (the warmup ends at pct_start *
    total - 1, the anneal at total - 1), clamped so that few-step runs stay
    finite."""
    total = max(float(total_steps), 1.0)
    warm_end = max(pct_start * total - 1.0, 1e-6)
    total_end = max(total - 1.0, warm_end + 1e-6)
    return warm_end, total_end


def _cos_anneal(start, end, pct: torch.Tensor) -> torch.Tensor:
    return end + (start - end) * 0.5 * (1.0 + torch.cos(math.pi * pct))


def _two_phase(total_steps, pct_start, first, second):
    warm_end, total_end = _onecycle_phases(total_steps, pct_start)

    def sched(step) -> torch.Tensor:
        step = _f32(step)
        up = torch.clamp(step / warm_end, 0.0, 1.0)
        down = torch.clamp((step - warm_end) / (total_end - warm_end), 0.0, 1.0)
        return torch.where(step <= warm_end, _cos_anneal(*first, up), _cos_anneal(*second, down))

    return sched


def onecycle_lr_schedule(total_steps: int, peak: float, pct_start: float, div_factor: float,
                         final_div_factor: float):
    """torch OneCycleLR (cos): a cosine from peak / div_factor up to peak over
    the warmup, then down to peak / div_factor / final_div_factor."""
    init = peak / div_factor
    return _two_phase(total_steps, pct_start, (init, peak), (peak, init / final_div_factor))


def momentum_schedule(total_steps: int, pct_start: float, base_m: float, max_m: float):
    """OneCycle's momentum, cycled against the learning rate: max -> base over
    the warmup, base -> max over the anneal."""
    return _two_phase(total_steps, pct_start, (max_m, base_m), (base_m, max_m))


def _prefixed(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


class AdamW:
    """optax's ``chain(clip_by_global_norm, inject_hyperparams(adamw),
    scale)`` over named parameters, updating them in place. ``state_dict``
    and ``load_state_dict`` carry the step count and the moments."""

    def __init__(self, named_params, lr_schedule, b1_schedule=None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                 max_norm: float = 1e9, scales: dict | None = None):
        self.params = dict(named_params)
        self.lr_schedule, self.b1_schedule = lr_schedule, b1_schedule
        self.b1, self.b2, self.eps, self.wd, self.max_norm = b1, b2, eps, weight_decay, max_norm
        self.scales = {k: (scales or {}).get(k, 1.0) for k in self.params}
        self.count = 0
        self.mu = {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                   for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                   for k, p in self.params.items()}

    def hyperparams(self, count: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(learning rate, b1) at step ``count`` (default: the next update)."""
        count = self.count if count is None else count
        b1 = self.b1_schedule(count) if self.b1_schedule is not None else _f32(self.b1)
        return self.lr_schedule(count), b1

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as zero),
        in multi-tensor (``torch._foreach_*``) ops over all parameters."""
        params = list(self.params.values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        mu, nu = list(self.mu.values()), list(self.nu.values())
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        keep = norm < self.max_norm
        # (g / norm) * max_norm where the norm reaches max_norm, else g
        g = torch._foreach_mul(torch._foreach_div(grads, torch.where(keep, 1.0, norm)),
                               torch.where(keep, 1.0, self.max_norm))
        lr, b1 = (float(v) for v in self.hyperparams())
        count = self.count + 1
        c1 = float(1.0 - _f32(b1) ** count)
        c2 = float(1.0 - _f32(self.b2) ** count)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, c1), den)
        torch._foreach_add_(u, torch._foreach_mul(params, self.wd))
        torch._foreach_mul_(u, -lr)
        torch._foreach_mul_(u, [self.scales[k] for k in self.params])
        torch._foreach_add_(params, u)
        self.count = count

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for k in self.params:
            self.mu[k].copy_(state["mu"][k])
            self.nu[k].copy_(state["nu"][k])


def param_scales(names, custom_keys: dict, frozen_prefixes=()) -> dict:
    """Each parameter's update scale: 0 under a frozen prefix, else the
    ``lr_mult`` of the first ``custom_keys`` prefix that matches it, else 1."""
    out = {}
    for n in names:
        if any(_prefixed(n, f) for f in frozen_prefixes):
            out[n] = 0.0
            continue
        out[n] = next((float(spec.get("lr_mult", 1.0)) for key, spec in custom_keys.items()
                       if _prefixed(n, key)), 1.0)
    return out


def build_optimizer(optim_cfg: dict, scheduler_cfg: dict, total_steps: int, named_params,
                    frozen_prefixes=()) -> tuple[AdamW, callable]:
    """(optimizer, lr schedule) of the config's ``optim_wrapper`` and
    ``param_scheduler`` over ``named_params`` (name, parameter) pairs."""
    opt = optim_cfg.get("optimizer", {})
    max_lr = float(opt.get("lr", 1e-4))
    wd = float(opt.get("weight_decay", 0.01))
    pct_start = float(scheduler_cfg.get("pct_start", 0.3))
    lr_schedule = onecycle_lr_schedule(
        total_steps, max_lr, pct_start, float(scheduler_cfg.get("div_factor", 25.0)),
        float(scheduler_cfg.get("final_div_factor", 1e4)))
    b1_schedule = None
    if scheduler_cfg.get("cycle_momentum", False):
        b1_schedule = momentum_schedule(total_steps, pct_start,
                                        float(scheduler_cfg.get("base_momentum", 0.85)),
                                        float(scheduler_cfg.get("max_momentum", 0.95)))
    named_params = list(named_params)
    custom_keys = optim_cfg.get("paramwise_cfg", {}).get("custom_keys", {})
    scales = param_scales([n for n, _ in named_params], custom_keys, frozen_prefixes)
    max_norm = float(optim_cfg.get("clip_grad", {}).get("max_norm", 1e9))
    return AdamW(named_params, lr_schedule, b1_schedule, weight_decay=wd, max_norm=max_norm,
                 scales=scales), lr_schedule
