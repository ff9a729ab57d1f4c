"""The learner's optimizer: an own copy of the optax chain the reference
builds (dotaclient_tpu/parallel/train_step.py make_optimizer),

    optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, eps=eps))

formula for formula, not `torch.optim` defaults:
- clip_by_global_norm: g_norm = sqrt(Σ Σ g²); every gradient is kept as it
  is when g_norm < max_norm, else replaced by (g / g_norm) · max_norm
  (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm: another function);
- scale_by_adam: mu = (1-b1)·g + b1·mu, nu = (1-b2)·g² + b2·nu, count += 1,
  update = m̂ / (sqrt(v̂ + eps_root) + eps) with m̂ = mu / (1 - b1^count),
  v̂ = nu / (1 - b2^count), eps_root = 0; then scaled by -lr and added.
The state keeps optax's (count, mu, nu), keyed by the flax param names, so
it carries across from an optax state (transport/params.py). Every op is a
multi-tensor (`torch._foreach_*`) call and the clip decision stays on the
device: an update does not wait for the host.

Under tensor parallelism (parallel/train_step.py) a tp rank keeps its
column slice of each sharded leaf and of its moments: the caller passes the
global norm of the whole gradient (`g_norm`) and the slices, and every op
after the norm is elementwise, so each slice's update is bitwise that
slice of the unsharded update.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

_INT32_MAX = 2**31 - 1
B1, B2 = 0.9, 0.999  # optax.adam's defaults, which the reference keeps


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar on the params' device
    mu: Dict[str, torch.Tensor]  # flax name -> first moment (f32), sorted by name
    nu: Dict[str, torch.Tensor]  # flax name -> second moment (f32)


class ClipAdam:
    """Global-norm clip, then Adam (optax's formulas; see the module)."""

    def __init__(self, max_norm: float, lr: float, eps: float):
        self.max_norm, self.lr, self.eps = max_norm, lr, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        names = sorted(params)
        zeros = lambda: {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
        device = params[names[0]].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """sqrt(Σ Σ g²) over a list of tensors (optax.global_norm)."""
        return torch.stack(torch._foreach_norm(list(grads))).square().sum().sqrt()

    def update(
        self, grads: Dict[str, torch.Tensor], state: AdamState, g_norm: Optional[torch.Tensor] = None
    ) -> Tuple[Dict[str, torch.Tensor], AdamState, torch.Tensor]:
        """optax's `update(grads, state)`: returns (updates, state', g_norm),
        g_norm being the global norm before the clip: `g_norm` when given
        (the whole gradient's, `grads` being slices of it), else the norm
        of `grads`, in the state's name order."""
        names = list(state.mu)
        if sorted(grads) != names:
            raise ValueError(f"gradient names differ from the optimizer state's: {sorted(set(grads) ^ set(names))}")
        g = [grads[n] for n in names]
        if g_norm is None:
            g_norm = self.global_norm(g)
        # t, or (t / g_norm) · max_norm: dividing and multiplying by 1 keeps t's bits
        keep = g_norm < self.max_norm
        one = torch.ones_like(g_norm)
        g = torch._foreach_div(g, torch.where(keep, one, g_norm))
        torch._foreach_mul_(g, torch.where(keep, one, torch.full_like(g_norm, self.max_norm)))

        mu = torch._foreach_mul(list(state.mu.values()), B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - B1))
        nu = torch._foreach_mul(list(state.nu.values()), B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2))
        count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
        c = count.float()
        bc1 = 1.0 - torch.pow(torch.full_like(c, B1), c)
        bc2 = 1.0 - torch.pow(torch.full_like(c, B2), c)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(upd, -self.lr)
        new_state = AdamState(count, dict(zip(names, mu)), dict(zip(names, nu)))
        return dict(zip(names, upd)), new_state, g_norm

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: AdamState,
              g_norm: Optional[torch.Tensor] = None):
        """update, then optax.apply_updates in place (p += u). Returns
        (state', g_norm)."""
        upd, state, g_norm = self.update(grads, state, g_norm)
        names = list(upd)
        torch._foreach_add_([params[n] for n in names], [upd[n] for n in names])
        return state, g_norm
