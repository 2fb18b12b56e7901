"""Six Adam steps of the raw-input model at the flagship's widths on one
batch, in the JAX package and in the port, on the CPU: whether lr 3e-3
lowers the focal loss from each framework's own initialisation and from
the same weights, and whose updates raise it.  A script, not a test: it
holds no test function, so pytest collects nothing here.

The batch is ``chip_smoke.py``'s raw-phase batch (its recipe from seed 0,
B = 32) cut to its first ``--B`` dialogues; the model is that phase's
fixed-batch model: IEMOCAP GDF with the reason-LSTM, 16 GCNII layers,
speaker weights 3-0-1, dropout 0, no class weights, no L2, the focal loss
(gamma 0.5), behind the default frontends (64 mels, n_fft 400, hop 160,
128 channels; DenseNet-BC growth 12, blocks (4, 8, 6), stem 32) on 3 s of
16 kHz audio and 48 x 48 x 3 crops.  It prints one JSON object:

* ``jax``: JAX's ``RawInputDialogueGNN`` from flax's initialisation;
* ``port_same_weights``: the port from those weights
  (``raw_params_from_jax``) and the largest relative difference of its
  losses from JAX's;
* ``port_own_init``: the port from its own seed-0 weights
  (``build_raw_model``);
* ``frozen``: the port from JAX's weights at lr 3e-3 with a part's
  parameters left out of the step;
* ``feature_scale``: the mean absolute value of each input of the graph
  model and of the log-mel head's input at the initial weights;
* ``small_flax_init``: ``tests/test_torch_frontends.py``'s three Adam steps
  (its sizes, lr 3e-3) from flax's own initialisation instead of that
  test's uniform weights: both frameworks' losses, their largest relative
  difference, and the first step's largest gradient difference over each
  gradient's max abs.

Run from the repository root (about 9 minutes and 7 GB at ``--B 4``;
``--small`` runs the last part alone, in seconds)::

    JAX_PLATFORMS=cpu python tests/test_torch_raw_lr_witness.py --B 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import chip_smoke  # noqa: E402
from mmdfn_tpu.config import ExperimentConfig as JConfig  # noqa: E402
from mmdfn_tpu.losses import focal_loss as j_focal_loss  # noqa: E402
from mmdfn_tpu.models.dialogue_gnn import (  # noqa: E402
    DialogueGNN as JDialogueGNN)
from mmdfn_tpu.models.raw_input import (  # noqa: E402
    RawInputDialogueGNN as JRaw)
from mmdfn_tpu.train.optim import torch_adam as j_torch_adam  # noqa: E402

from mmdfn_torch.config import ExperimentConfig  # noqa: E402
from mmdfn_torch.train import Trainer  # noqa: E402
from mmdfn_torch.weights import (build_raw_model,  # noqa: E402
                                 raw_params_from_jax)

LRS = (3e-3, 3e-4)
STEPS = 6
INPUTS = ("text", "qmask", "umask", "audio", "visual")
FIELDS = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              Deep_GCN_nlayers=chip_smoke.NLAYERS, speaker_weights="3-0-1",
              dropout=0.0, class_weight=False, l2=0.0, seed=chip_smoke.SEED)


def batch(B: int) -> dict:
    rng = np.random.default_rng(chip_smoke.SEED)
    full = chip_smoke.raw_batch(torch, rng, "cpu")
    return {k: v[:B].numpy() for k, v in full.items()}


def jax_losses(inputs: dict) -> tuple:
    """flax's initial weights, and the losses of 6 steps at each lr."""
    jm = JRaw(model=JDialogueGNN.from_config(JConfig(**FIELDS)).clone(
        D_m_a=300, D_m_v=342), audio_out_dim=300, visual_out_dim=342)
    args = tuple(jnp.asarray(inputs[k]) for k in INPUTS)
    label = jnp.asarray(inputs["label"].astype(np.int32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"]

    @jax.jit
    def loss_grad(p, args, label):
        return jax.value_and_grad(lambda q: j_focal_loss(
            jm.apply({"params": q}, *args), label, args[2], gamma=0.5))(p)

    out = {}
    for lr in LRS:
        tx = j_torch_adam(lr)
        update = jax.jit(lambda g, s, p: tx.update(g, s, p))
        p, s, losses = params, tx.init(params), []
        for _ in range(STEPS):
            loss, g = loss_grad(p, args, label)
            u, s = update(g, s, p)
            p = optax.apply_updates(p, u)
            losses.append(float(loss))
        out[str(lr)] = losses
    return jax.tree_util.tree_map(np.asarray, params), out


def port_losses(inputs: dict, lr: float, state_dict=None,
                frozen: tuple = ()) -> list:
    cfg = dataclasses.replace(ExperimentConfig(**FIELDS), lr=lr)
    tr = Trainer(cfg, device="cpu", model=build_raw_model(cfg, state_dict))
    for name, p in tr.model.named_parameters():
        if name.startswith(frozen):
            p.requires_grad_(False)        # no gradient: Adam skips it
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return [float(tr.train_step(x, seed=700 + i)[0]) for i in range(STEPS)]


def feature_scale(inputs: dict, state_dict) -> dict:
    cfg = ExperimentConfig(**FIELDS)
    model = build_raw_model(cfg, state_dict)
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    seen = {}
    model.audio_frontend.proj.register_forward_hook(
        lambda m, i, o: seen.update(log_mel_head_input=i[0]))
    with torch.no_grad():
        audio = model.audio_frontend(x["audio"])
        visual = model.visual_frontend(x["visual"])
    valid = x["umask"] > 0
    mean_abs = lambda t: float(t[valid.reshape(-1)].abs().mean()
                               if t.dim() == 2 else t[valid].abs().mean())
    return {"text": mean_abs(x["text"]), "audio_features": mean_abs(audio),
            "visual_features": mean_abs(visual),
            "log_mel_head_input": mean_abs(seen["log_mel_head_input"])}


def small_flax_init() -> dict:
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_frontends as tf

    inputs = tf._raw_inputs()
    jm = JRaw(model=JDialogueGNN.from_config(JConfig(**tf.CFG)).clone(
        D_m_a=300, D_m_v=342), audio_out_dim=300, visual_out_dim=342,
              **tf.FRONT)
    args = tuple(jnp.asarray(inputs[k]) for k in INPUTS)
    label = jnp.asarray(inputs["label"].astype(np.int32))
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    tx = j_torch_adam(tf.CFG["lr"])

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(lambda q: j_focal_loss(
            jm.apply({"params": q}, *args), label, args[2], gamma=0.5))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g

    p, s, want = params, tx.init(params), []
    for i in range(3):
        p, s, loss, g = step(p, s)
        want.append(float(loss))
        if i == 0:
            want_g = raw_params_from_jax(
                jax.tree_util.tree_map(np.asarray, g))
    tr = Trainer(ExperimentConfig(**tf.CFG), device="cpu",
                 model=tf._port_model(jax.tree_util.tree_map(np.asarray,
                                                             params)))
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    got = []
    for i in range(3):
        got.append(float(tr.train_step(x, seed=i)[0]))
        if i == 0:
            grad_err = max(
                float((p.grad - want_g[k]).abs().max())
                / max(float(want_g[k].abs().max()), 1e-12)
                for k, p in tr.model.named_parameters())
    return {"jax": want, "port": got,
            "max_rel": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
            "first_step_grad_err_of_scale": grad_err}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=4, help="dialogues (of 32)")
    ap.add_argument("--small", action="store_true",
                    help="only the small_flax_init part")
    args = ap.parse_args()
    t0 = time.perf_counter()
    small = small_flax_init()
    if args.small:
        print(json.dumps({"small_flax_init": small}))
        return 0
    inputs = batch(args.B)
    params, jax_out = jax_losses(inputs)
    sd = raw_params_from_jax(params)
    same = {str(lr): port_losses(inputs, lr, sd) for lr in LRS}
    rel = max(abs(a - b) / abs(b) for lr in same
              for a, b in zip(same[lr], jax_out[lr]))
    own = {str(lr): port_losses(inputs, lr) for lr in LRS}
    frozen = {name: port_losses(inputs, LRS[0], sd, parts) for name, parts in
              (("audio_frontend", ("audio_frontend.",)),
               ("visual_frontend", ("visual_frontend.",)),
               ("both_frontends", ("audio_frontend.", "visual_frontend.")),
               ("graph_model", ("model.",)))}
    print(json.dumps({
        "B": args.B, "utterances": int(inputs["umask"].sum()),
        "jax": jax_out, "port_same_weights": same,
        "port_vs_jax_max_rel": rel, "port_own_init": own,
        "frozen_lr0.003": frozen, "feature_scale": feature_scale(inputs, sd),
        "small_flax_init": small, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
