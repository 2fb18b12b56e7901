"""The reference's training steps and evaluation: the first steps of a group
of configurations from their shared starting weights, each with its own
lr, L2, dropout rate and focal gamma, under torch Adam's arithmetic with
coupled L2 (``weight_decay``: the decay added to the gradient before the
moments), and a forward over the test batches at the starting weights.

The configurations are computed in blocks of ``block``, one after another,
so that the autograd graph of a whole group need not fit at once; the
blocks share each step's dropout draws (``model.Draws``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from portbench.reference import model as M

BETAS = (0.9, 0.999)
EPS = 1e-8


def step_seed(seed: int, i: int) -> int:
    """The dropout seed of step i of an epoch: 63 bits of numpy's
    ``SeedSequence([seed, 0, i])``, the same stream every epoch."""
    state = np.random.SeedSequence([seed, 0, i]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _col(vals, ref: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(vals, np.float64), dtype=torch.float32,
                        device=ref.device)
    return t.reshape(-1, *([1] * (ref.dim() - 1)))


def follow(p0: Dict[str, torch.Tensor], cfg: dict, combos: Sequence[dict],
           batches: Sequence[Dict[str, torch.Tensor]],
           seeds: Sequence[int], test_batches: Sequence[Dict[str,
                                                              torch.Tensor]],
           alpha: Optional[torch.Tensor], block: int,
           half_batch: bool = False) -> dict:
    """Every configuration's losses on ``batches`` (one Adam step each), the
    norm of each leaf's first gradient as Adam takes it (with the L2 term),
    the norm of each leaf's change after the last step, and the test
    batches' log-probs at the starting weights.

    ``p0``: the shared starting weights (no config axis); ``batches`` and
    ``test_batches``: dicts of device tensors text, audio, visual, qmask,
    umask, label; ``seeds``: each step's dropout seed.  ``half_batch``
    leaves the second half of each training batch out (a planted fault).
    Returns numpy arrays: ``loss`` (K, steps), ``grad`` and ``change`` (K,
    leaves), ``eval0_logp`` a list of (K, B, L, C) per test batch, and
    the leaf ``names``."""
    dev = next(iter(p0.values())).device
    names = list(p0)
    K = len(combos)
    rates_all = [float(c["dropout"]) for c in combos]
    drop = any(r > 0.0 for r in rates_all)
    draws = [M.Draws(torch.Generator(device=dev).manual_seed(s), dev)
             for s in seeds] if drop else [None] * len(seeds)
    out = dict(loss=np.zeros((K, len(batches))),
               grad=np.zeros((K, len(names))),
               change=np.zeros((K, len(names))),
               eval0_logp=[[] for _ in test_batches], names=names)
    for k0 in range(0, K, block):
        ks = list(range(k0, min(K, k0 + block)))
        Kb = len(ks)
        lr = [float(combos[k]["lr"]) for k in ks]
        l2 = [float(combos[k]["l2"]) for k in ks]
        gam = [float(combos[k]["gamma"]) for k in ks]
        rates = M.Rates([rates_all[k] for k in ks], dev)
        p = {n: t.detach().expand(Kb, *t.shape).clone().requires_grad_()
             for n, t in p0.items()}
        with torch.no_grad():
            for i, tb in enumerate(test_batches):
                lp = M.forward(p, cfg, tb["text"], tb["audio"], tb["visual"],
                               tb["qmask"], tb["umask"])
                out["eval0_logp"][i].append(lp.cpu().numpy())
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        for s, batch in enumerate(batches):
            umask = batch["umask"]
            if half_batch:
                umask = umask.clone()
                umask[umask.shape[0] // 2:] = 0.0
            if draws[s] is not None:
                draws[s].rewind()
            logp = M.forward(p, cfg, batch["text"], batch["audio"],
                             batch["visual"], batch["qmask"], umask,
                             draws[s], rates if drop else None)
            loss = M.focal_loss(logp, batch["label"], umask, gam, alpha)
            grads = torch.autograd.grad(loss.sum(), [p[n] for n in names])
            out["loss"][ks, s] = loss.detach().double().cpu().numpy()
            t = s + 1
            with torch.no_grad():
                for j, n in enumerate(names):
                    g = grads[j] + _col(l2, p[n]) * p[n]
                    if s == 0:
                        out["grad"][ks, j] = g.flatten(1).double().norm(
                            dim=1).cpu().numpy()
                    m[n] = m[n] + (g - m[n]) * (1 - BETAS[0])
                    v[n] = v[n] * BETAS[1] + (1 - BETAS[1]) * g * g
                    size = _col([x / (1 - BETAS[0] ** t) for x in lr], p[n])
                    denom = (v[n].sqrt() / (1 - BETAS[1] ** t) ** 0.5) + EPS
                    p[n] -= size * m[n] / denom
            del grads, logp, loss
        with torch.no_grad():
            for j, n in enumerate(names):
                out["change"][ks, j] = (p[n] - p0[n]).flatten(1).double() \
                    .norm(dim=1).cpu().numpy()
        del p, m, v
    out["eval0_logp"] = [np.concatenate(x) for x in out["eval0_logp"]]
    return out
