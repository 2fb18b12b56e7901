"""The reference's optimiser (``mmdfn_tpu/train/optim.py``): torch Adam
with ``weight_decay=l2``, i.e. coupled L2, the decay added to the gradient
before the moment updates (``code/run_train_erc.py:512``)."""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
