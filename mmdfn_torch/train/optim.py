"""The reference's optimiser (``mmdfn_tpu/train/optim.py``): torch Adam
with ``weight_decay=l2``, i.e. coupled L2, the decay added to the gradient
before the moment updates (``code/run_train_erc.py:512``).

:class:`StackedAdam` is the grouped sweep's Adam (JAX: ``_adam_update``,
``mmdfn_tpu/train/vmap_sweep.py:92-117``): one optimiser over parameters
stacked on a leading config axis, with each configuration's own lr, l2 and
step count, and a freeze mask.  It runs torch Adam's own foreach
arithmetic (``torch.optim.adam._multi_tensor_adam``, the default on the
card; on the CPU the foreach ops run torch's per-tensor ops, those of its
default there) on the configurations' slices, so configuration k's slice
moves exactly as ``torch.optim.Adam`` moves that configuration alone.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

BETAS = (0.9, 0.999)
EPS = 1e-8


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


class StackedAdam:
    """Adam (coupled L2) over parameters of shape (K, ...), configuration k
    at ``lr[k]`` and ``l2[k]``.

    ``step(active)`` updates the active configurations from the
    parameters' ``.grad`` (a parameter whose gradient is None is skipped,
    as torch skips it); a frozen configuration's parameters, moments and
    step count do not move (JAX's freeze mask).  The step count is kept
    per parameter and configuration, as torch keeps one per parameter.
    ``config_state_dict(k)`` / ``load_config_state_dict(k, state)`` read
    and write configuration k's state in ``torch.optim.Adam``'s layout."""

    def __init__(self, params: Sequence[Tensor], lr: Sequence[float],
                 l2: Sequence[float]):
        self.params = list(params)
        self.K = len(lr)
        self.lr = [float(v) for v in lr]
        self.l2 = [float(v) for v in l2]
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        # torch keeps each step count as an f32 scalar on the CPU
        self.steps = np.zeros((len(self.params), self.K), np.float32)
        template = torch.optim.Adam([torch.zeros(1)], lr=1.0)
        self._group = {k: v for k, v in template.state_dict()
                       ["param_groups"][0].items() if k != "params"}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, active: Sequence[bool]) -> None:
        slots = [(i, k) for i, p in enumerate(self.params)
                 if p.grad is not None for k in range(self.K) if active[k]]
        if not slots:
            return
        b1, b2 = BETAS
        params = [self.params[i][k] for i, k in slots]
        grads = [self.params[i].grad[k] for i, k in slots]
        exp_avgs = [self.exp_avg[i][k] for i, k in slots]
        exp_avg_sqs = [self.exp_avg_sq[i][k] for i, k in slots]
        for i, k in slots:
            self.steps[i, k] += np.float32(1.0)
        # the coupled L2, one foreach call per distinct l2 (torch's alpha is
        # one scalar a call)
        for wd in sorted({self.l2[k] for _, k in slots}):
            if wd == 0.0:
                continue
            at = [j for j, (_, k) in enumerate(slots) if self.l2[k] == wd]
            decayed = torch._foreach_add([grads[j] for j in at],
                                         [params[j] for j in at], alpha=wd)
            for j, g in zip(at, decayed):
                grads[j] = g
        torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
        torch._foreach_mul_(exp_avg_sqs, b2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - b2)
        del grads
        steps = [float(self.steps[i, k]) for i, k in slots]
        step_size = [(self.lr[k] / (1 - b1 ** t)) * -1
                     for (_, k), t in zip(slots, steps)]
        bias_correction2_sqrt = [(1 - b2 ** t) ** 0.5 for t in steps]
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, bias_correction2_sqrt)
        torch._foreach_add_(denom, EPS)
        torch._foreach_addcdiv_(params, exp_avgs, denom, step_size)

    # ------------------------------------------------------------------
    def config_defaults(self, k: int) -> dict:
        return dict(self._group, lr=self.lr[k], weight_decay=self.l2[k])

    def config_state_dict(self, k: int) -> dict:
        """Configuration k's state as ``torch.optim.Adam.state_dict()``
        gives it for that configuration alone (copies, on the parameters'
        device)."""
        state = {i: {"step": torch.tensor(float(self.steps[i, k])),
                     "exp_avg": self.exp_avg[i][k].clone(),
                     "exp_avg_sq": self.exp_avg_sq[i][k].clone()}
                 for i in range(len(self.params)) if self.steps[i, k] > 0}
        group = dict(self.config_defaults(k),
                     params=list(range(len(self.params))))
        return {"state": state, "param_groups": [group]}

    @torch.no_grad()
    def load_config_state_dict(self, k: int, state: dict) -> None:
        """Configuration k's state from ``torch.optim.Adam``'s layout."""
        per = state["state"]
        for i in range(len(self.params)):
            st = per.get(i, per.get(str(i)))
            if st is None:
                self.steps[i, k] = 0.0
                self.exp_avg[i][k].zero_()
                self.exp_avg_sq[i][k].zero_()
                continue
            self.steps[i, k] = np.float32(float(st["step"]))
            self.exp_avg[i][k].copy_(st["exp_avg"])
            self.exp_avg_sq[i][k].copy_(st["exp_avg_sq"])


class ConfigAdam:
    """Configuration k of a :class:`StackedAdam`, with the surface of its
    own ``torch.optim.Adam`` that a checkpoint and a caller read:
    ``defaults``, ``state_dict()`` and ``load_state_dict()``."""

    def __init__(self, stacked: StackedAdam, k: int):
        self.stacked, self.k = stacked, k

    @property
    def defaults(self) -> dict:
        return self.stacked.config_defaults(self.k)

    def state_dict(self) -> dict:
        return self.stacked.config_state_dict(self.k)

    def load_state_dict(self, state: dict) -> None:
        self.stacked.load_config_state_dict(self.k, state)

