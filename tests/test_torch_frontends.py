"""The raw-input path of the port against the JAX package: the log-mel
spectrogram, ``LogMelFrontend`` (flax's 'SAME' padding, symmetric and
not), ``DenseNetFrontend`` and its batch independence, and
``RawInputDialogueGNN``'s log-probs and three Adam steps of the focal loss
on bridged weights, at ``tests/test_raw_input.py``'s sizes."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.frontends import DenseNetFrontend as JDenseNet
from mmdfn_tpu.frontends import LogMelFrontend as JLogMel
from mmdfn_tpu.frontends import log_mel_spectrogram as j_log_mel
from mmdfn_tpu.losses import focal_loss as j_focal_loss
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.models.raw_input import RawInputDialogueGNN as JRaw
from mmdfn_tpu.train.optim import torch_adam as j_torch_adam

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.frontends import (DenseNetFrontend, LogMelFrontend,
                                   log_mel_spectrogram)
from mmdfn_torch.models import DialogueGNN, RawInputDialogueGNN
from mmdfn_torch.train import Trainer
from mmdfn_torch.weights import _frontend_from_jax, raw_params_from_jax


# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_raw_input.py's sizes
B, L, S, HW = 2, 4, 1600, 16
MEL = dict(n_fft=256, hop=128, n_mels=24)
T = torch.from_numpy


def _jax_params(module, *args, seed=0, bound=0.1):
    """Uniform weights shaped as ``module``'s parameters (no JAX
    initialisation to run); GroupNorm scales about 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args))["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(-bound, bound, s.shape)
                      + (jax.tree_util.keystr(p).endswith("['scale']")))
        .astype(np.float32), shapes)


def _bridge(sub):
    sd = {}
    _frontend_from_jax(sd, "", jax.tree_util.tree_map(np.asarray, sub))
    return sd


def test_log_mel_matches_jax():
    wav = np.random.default_rng(0).standard_normal((B, L, S)).astype(
        np.float32)
    wav[1, 3] = 0.0                    # a pad utterance: log(1e-6) throughout
    got = log_mel_spectrogram(T(wav), sample_rate=16000, **MEL).numpy()
    want = np.asarray(j_log_mel(jnp.asarray(wav), sample_rate=16000, **MEL))
    assert got.shape == want.shape == (B, L, 11, 24)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# 'SAME' padding of the strided convs (k 5, then k 3, stride 2): 9 frames
# pad 2 + 2, then 5 frames 1 + 1 (symmetric); 12 frames pad 1 + 2, then 6
# frames 0 + 1 (the extra element at the end)
@pytest.mark.parametrize("n_samples,frames", [(1280, 9), (1664, 12)],
                         ids=["symmetric", "asymmetric"])
def test_log_mel_frontend_matches_jax(n_samples, frames):
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((B, L, n_samples)).astype(np.float32)
    jm = JLogMel(out_dim=64, channels=16, **MEL)
    params = _jax_params(jm, jnp.asarray(wav), seed=1)
    want = np.asarray(fast_jit(jm.apply)({"params": params},
                                        jnp.asarray(wav)))
    pm = LogMelFrontend(out_dim=64, channels=16, **MEL)
    pm.load_state_dict(_bridge(params))
    got = pm(T(wav))
    assert 1 + (n_samples - MEL["n_fft"]) // MEL["hop"] == frames
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)


def test_densenet_frontend_matches_jax_and_is_batch_independent():
    """A small DenseNet (growth 8, blocks (2, 2), stem 16: one transition
    of 40 -> 20 channels) on 16 x 16 crops; one utterance's features do not
    depend on the rest of the batch (``tests/test_frontends.py:82-91``)."""
    frames = np.random.default_rng(2).standard_normal(
        (B, 2, HW, HW, 3)).astype(np.float32)
    kw = dict(out_dim=16, growth=8, block_config=(2, 2), stem_channels=16)
    jm = JDenseNet(**kw)
    params = _jax_params(jm, jnp.asarray(frames), seed=2)
    want = np.asarray(fast_jit(jm.apply)({"params": params},
                                        jnp.asarray(frames)))
    pm = DenseNetFrontend(**kw)
    pm.load_state_dict(_bridge(params))
    with torch.no_grad():
        full = pm(T(frames)).numpy()
        solo = pm(T(frames[:1])).numpy()
    np.testing.assert_allclose(full, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(full[:1], solo, atol=1e-5, rtol=0)


def _raw_inputs():
    """``tests/test_raw_input.py``'s batch: utterance 3 of dialogue 1 is
    padding (zero waveform, random frames)."""
    rng = np.random.default_rng(0)
    umask = np.ones((B, L), np.float32)
    umask[1, 3:] = 0
    text = (rng.standard_normal((B, L, 100)) * umask[..., None]).astype(
        np.float32)
    wav = (rng.standard_normal((B, L, S)) * umask[..., None]).astype(
        np.float32)
    frames = rng.standard_normal((B, L, HW, HW, 3)).astype(np.float32)
    spk = rng.integers(0, 2, size=(B, L))
    qmask = np.zeros((B, L, 2), np.float32)
    qmask[np.arange(B)[:, None], np.arange(L)[None], spk] = 1
    qmask *= umask[..., None]
    label = (rng.integers(0, 6, size=(B, L)) * umask).astype(np.int64)
    return dict(text=text, qmask=qmask, umask=umask, audio=wav,
                visual=frames, label=label)


# tests/test_raw_input.py's Adam (lr 3e-3, no L2).  Adam's first update
# is about lr x sign(g), so a gradient entry near 0, where the two
# frameworks' f32 sums round apart, moves its weight by up to lr either
# way: from flax's own initialisation (DenseNet growth 8, 16 x 16 crops)
# the third losses part by 1.48e-5 relative while the first step's
# gradients agree within 2.6e-6 of their scale (``python
# tests/test_torch_raw_lr_witness.py --small``); from these uniform
# weights the losses agree within 1e-5
CFG = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
           Deep_GCN_nlayers=2, dropout=0.0, lr=3e-3, l2=0.0, gamma=0.5)
FRONT = dict(densenet_growth=8, **MEL)


@pytest.fixture(scope="module")
def jax_run():
    """Three Adam steps of the JAX model (focal loss, gamma 0.5, no
    dropout): the initial log-probs and gradients, and each step's loss,
    from one jitted step."""
    inputs = _raw_inputs()
    jm = JRaw(model=JDialogueGNN.from_config(JConfig(**CFG)).clone(
        D_m_a=300, D_m_v=342), audio_out_dim=300, visual_out_dim=342,
              **FRONT)
    args = tuple(jnp.asarray(inputs[k]) for k in
                 ("text", "qmask", "umask", "audio", "visual"))
    params = _jax_params(jm, *args)
    tx = j_torch_adam(CFG["lr"])
    label, umask = jnp.asarray(inputs["label"]), args[2]

    @jax.jit
    def step(p, opt):
        def loss_fn(q):
            logp = jm.apply({"params": q}, *args)
            return j_focal_loss(logp, label, umask, gamma=0.5), logp
        (loss, logp), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, loss, logp, grads

    p, opt = params, fast_jit(tx.init)(params)
    losses = []
    for i in range(3):
        p, opt, loss, logp, grads = step(p, opt)
        losses.append(float(loss))
        if i == 0:
            logp0, grads0 = np.asarray(logp), grads
    return dict(inputs=inputs, params=params, logp=logp0, grads=grads0,
                losses=losses)


def _port_model(params):
    model = RawInputDialogueGNN.from_config(ExperimentConfig(**CFG), **FRONT)
    model.load_state_dict(raw_params_from_jax(params))
    return model


def test_raw_model_log_probs_match_jax(jax_run):
    inputs = jax_run["inputs"]
    model = _port_model(jax_run["params"])
    with torch.no_grad():
        got = model(*(T(inputs[k]) for k in
                      ("text", "qmask", "umask", "audio", "visual"))).numpy()
    valid = inputs["umask"] > 0
    np.testing.assert_allclose(got[valid], jax_run["logp"][valid],
                               atol=1e-4, rtol=0)


def test_three_adam_steps_match_jax(jax_run):
    """``Trainer.train_step`` of the port's raw model (focal loss, Adam,
    dropout 0): three losses within 1e-5 relative, the first
    step's gradients within 1e-4 of each max abs; both frontends get
    gradients."""
    tr = Trainer(ExperimentConfig(**CFG), device="cpu",
                 model=_port_model(jax_run["params"]))
    inputs = {k: T(v) for k, v in jax_run["inputs"].items()}
    losses = []
    for i in range(3):
        loss, _ = tr.train_step(inputs, seed=i)
        losses.append(float(loss))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in
                     tr.model.named_parameters()}
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    want = raw_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_run["grads"]))
    assert want.keys() == grads.keys()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        err = float((grads[k] - w).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)
    for front in ("audio_frontend", "visual_frontend"):
        assert any(float(g.abs().max()) > 0 for k, g in grads.items()
                   if k.startswith(front)), front


def test_fresh_weights_follow_the_seed_and_flax_init():
    """A seed draws the graph model as ``DialogueGNN`` alone draws it, then
    the frontends: flax's truncated LeCun normal convolutions (std
    sqrt(1 / fan_in), cut at two of their standard deviations), unit
    GroupNorm scales, zero conv biases."""
    cfg = ExperimentConfig(**CFG)
    raw = RawInputDialogueGNN.from_config(cfg, **FRONT)
    raw.reset_parameters(torch.Generator().manual_seed(7))
    alone = DialogueGNN.from_config(cfg, D_m_a=300, D_m_v=342)
    alone.reset_parameters(torch.Generator().manual_seed(7))
    for k, v in alone.state_dict().items():
        assert torch.equal(raw.model.state_dict()[k], v), k
    for conv in (raw.audio_frontend.conv2,
                 raw.visual_frontend.block1_layer0.conv1x1):
        w = conv.weight.detach()
        std = (1.0 / w[0].numel()) ** 0.5
        assert abs(float(w.std()) / std - 1.0) < 0.05
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
    assert not raw.audio_frontend.conv1.bias.any()
    norm = raw.visual_frontend.trans0.norm
    assert bool((norm.weight == 1).all()) and not norm.bias.any()
    assert norm.num_groups == 8 and norm.eps == 1e-6
