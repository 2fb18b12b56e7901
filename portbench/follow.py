"""The reference's side of a run: its own inputs (the same dialogues and
starting weights the program gets, batched and seeded by the reference's
own arithmetic) and its steps (``reference/train.py``), for the harness's
check and for the control."""

from __future__ import annotations

import itertools
from typing import List

from portbench import data
from portbench.reference import batches as rb
from portbench.reference import model as M
from portbench.reference import train as rt


def group_combos(grid: dict, K: int, group: int = 0) -> List[dict]:
    """The grid's combinations of lr, l2, dropout and gamma, in the
    reference scripts' nesting order; the ``group``-th block of K."""
    keys = ("lr", "l2", "dropout", "gamma")
    combos = [dict(zip(keys, v)) for v in
              itertools.product(*(grid[k] for k in keys))]
    return combos[group * K:(group + 1) * K]


def split(conf: dict, seed: int):
    w = conf["widths"]
    dims = {"text": w["D_text"], "audio": w["D_audio"],
            "visual": w["D_visual"]}
    return data.dialogues(conf["data"], dims, w["n_speakers"],
                          w["n_classes"], seed)


def run(conf: dict, traffic: dict, seed: int, device, tf32: bool = False,
        half_batch: bool = False) -> dict:
    """The reference's numbers for a run's checked steps and evaluation;
    ``tf32`` computes its f32 products in TF32 (the control),
    ``half_batch`` leaves half of each training batch out (a planted
    fault)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    train, test = split(conf, seed)
    w, m = conf["widths"], conf["model"]
    bs, n_check = int(traffic["batch_size"]), int(traffic["check_steps"])
    buckets = m["buckets"]
    p0 = data.weights(M.param_shapes(w, m["Deep_GCN_nlayers"]), seed,
                      device)
    lens = [len(d) for d in train]
    sched = rb.schedule(lens, bs, buckets, int(traffic["shuffle_seed"]),
                        0)[:n_check]
    steps = [rb.to_device(rb.collate(train, idx, bs, L, w["n_speakers"]),
                          device) for idx, L in sched]
    tl = [len(d) for d in test]
    tests = [rb.collate(test, idx, bs, L, w["n_speakers"]) for idx, L in
             rb.schedule(tl, bs, buckets, 0, 0, shuffle=False)]
    combos = group_combos(conf["grid"], int(traffic["K"]),
                          int(traffic.get("group", 0)))
    out = rt.follow(p0, M.ref_config(conf), combos, steps,
                    [rt.step_seed(seed, i) for i in range(n_check)],
                    [rb.to_device(t, device) for t in tests],
                    M.class_weights(conf, device), int(traffic["ref_block"]),
                    half_batch=half_batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["umasks"] = [t["umask"] for t in tests]
    return out
