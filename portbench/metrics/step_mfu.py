"""``step_mfu``: the whole group step's share of the card's f32 peak over
the window, in %: the model's matmul operations of every training step
(forward and backward of one configuration, times K) and every
evaluation (the forward of each test batch, times K) in the window, over
the window's seconds times 67 TFLOP/s (an H100 SXM's published f32 peak
at 700 W; the configurations are f32 with TF32 off).  The operations are
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
reference model (``reference/model.py``) on the ``meta`` device, at each
batch's shape, with no recompute."""

from functools import lru_cache

PEAK_FP32 = 67e12


@lru_cache(maxsize=None)
def _flops(cfg_key, B, L, train):
    import json

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import model as M

    conf = json.loads(cfg_key)
    m, w = conf["model"], conf["widths"]
    nl = m["Deep_GCN_nlayers"]
    P = w["n_speakers"]
    dims = {"l": w["D_text"], "a": w["D_audio"], "v": w["D_visual"]}
    shapes = M.param_shapes(w, nl)
    meta = lambda *s: torch.zeros(s, device="meta")
    p = {n: torch.zeros((1, *s), device="meta", requires_grad=train)
         for n, s in shapes.items()}
    ref = M.ref_config(conf)
    qmask = meta(B, L, P)
    umask = meta(B, L)
    label = torch.zeros(B, L, dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as fc:
        if train:
            draws = M.Draws(None, "meta")
            logp = M.forward(p, ref, meta(B, L, dims["l"]),
                             meta(B, L, dims["a"]), meta(B, L, dims["v"]),
                             qmask, umask, draws, M.Rates([0.4], "meta"))
            M.focal_loss(logp, label, umask, [0.5], None).sum().backward()
        else:
            with torch.no_grad():
                M.forward(p, ref, meta(B, L, dims["l"]),
                          meta(B, L, dims["a"]), meta(B, L, dims["v"]),
                          qmask, umask)
    return fc.get_total_flops()


def read(ctx):
    import json

    key = json.dumps(ctx["cfg"], sort_keys=True)
    total = 0
    for u in ctx["units"]:
        if u[0] == "step":
            total += _flops(key, u[1], u[2], True)
        else:
            total += sum(_flops(key, B, L, False) for B, L in u[1])
    if total <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["K"] * total / (ctx["window_s"] * PEAK_FP32)
