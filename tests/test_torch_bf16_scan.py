"""The GCNII stack's bf16 layer scan in the port (``gcn_compute_dtype=
'bfloat16'`` wherever JAX's ``GCNIIStack`` runs its ``lax.scan``: GF2,
DeepGCN, ``variant=False``, the post-loop dropout, more than 64 layers, a
model axis, and every stack without a Pallas backend): the plain scan mode
(the plain version of kernels B and D's bf16 scan mode) against
``mmdfn_tpu``'s ``GCNIIStack(compute_dtype='bfloat16')``, kernel D's
reverse walk in plain ops against autograd, the bf16 grid at 16 layers,
GF2's and DeepGCN's models and Trainer steps under ``with_tpu_fast()``,
the flagship under ``gcn_compute_dtype`` alone, ``MMGCN(variant=False)``
under the preset, and ``--transfer_dtype bfloat16``."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.nn.gcn import GCNIIStack as JGCNIIStack
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.models.mm_gcn import MMGCN
from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.ops import gcnii_stack_fwd
from mmdfn_torch.ops.gcnii import (SCAN, _scan_bwd_plain, _scan_plain,
                                   residual_slabs)
from mmdfn_torch.train import Trainer


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


B, N, D, H = 2, 24, 24, 32
# the plain scan mode's bound against JAX's bf16 scan, of each output's
# scale: every reading below is 0 (the same bits; the bias gradients
# aside), and a bf16 step is 2^-8 of the scale at the largest element
BOUND = 1e-3
# the LSTM biases' gradients: JAX's transpose sums their rows in bf16 (XLA
# rounds each add, in windows of rows), the port in f32 rounded once
BIAS_BOUND = 3e-2

# the reference wirings (mmdfn_tpu/nn/gcn.py:61-80) and the non-variant
# update: (name, stack options, reason, input width)
WIRINGS = [
    ("GCNII_lyc", dict(dropout_mode="after"), True, D),
    ("GCNII_lyc", dict(dropout_mode="after"), False, D),
    ("GCNII", dict(dropout_mode="none", post_loop_dropout=True), True, D),
    ("GCNII", dict(dropout_mode="none", post_loop_dropout=True), False, D),
    ("MM_GCN2", dict(has_fc_in=False, dropout_mode="before",
                     post_loop_dropout=True), False, H),
    ("GCNII_lyc, variant=False", dict(dropout_mode="after", variant=False),
     True, D),
    ("GCNII, variant=False", dict(dropout_mode="none",
                                  post_loop_dropout=True, variant=False),
     False, D),
]


def _scaled(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_stack(nl, opts, reason, width, seed=0):
    """JAX's stack (compute_dtype bf16) on seeded inputs: the output and
    ``jax.vjp`` of (params, x, adj) under one jit, and the params."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((B, N, width))).astype(np.float32)
    adj = rng.uniform(0.0, 1.0, (B, N, N)).astype(np.float32)
    adj = (adj / adj.sum(-1, keepdims=True)).astype(np.float32)
    dy = rng.standard_normal((B, N, H)).astype(np.float32)
    jm = JGCNIIStack(nlayers=nl, nhidden=H, alpha=0.1, reason_flag=reason,
                     compute_dtype="bfloat16", **opts)
    params = fast_jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                               jnp.asarray(adj))

    def f(p, x, a):
        return jm.apply({"params": p}, x, a)[1]

    @fast_jit
    def g(p, x, a, dy):
        y, vjp = jax.vjp(f, p, x, a)
        return y, vjp(dy)
    y, (dp, dx, da) = g(params["params"], x, adj, dy)
    tree = jax.tree_util.tree_map(np.asarray, dp)
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    return x, adj, dy, p, (np.asarray(y), tree, np.asarray(dx),
                           np.asarray(da))


def _port_stack(nl, opts, reason, width, params, x, adj, dy, compute_dtype):
    """The port's stack with JAX's weights: (output, [dx, d_adj, dW,
    (d ih, d hh, d b_ih, d b_hh)]) in JAX's orientation."""
    m = GCNIIStack(width, nl, H, alpha=0.1, reason_flag=reason,
                   compute_dtype=compute_dtype, **opts)
    with torch.no_grad():
        if "fc_in" in params:
            m.fcs[0].weight.copy_(torch.tensor(params["fc_in"]["kernel"].T))
            m.fcs[0].bias.copy_(torch.tensor(params["fc_in"]["bias"]))
        for layer, w in zip(m.convs, params["conv_w"]):
            layer.weight.copy_(torch.tensor(w))
        if reason:
            r = m.rnn
            r.weight_ih_l0.copy_(torch.tensor(params["reason_w_ih"].T))
            r.weight_hh_l0.copy_(torch.tensor(params["reason_w_hh"].T))
            r.bias_ih_l0.copy_(torch.tensor(params["reason_b_ih"]))
            r.bias_hh_l0.copy_(torch.tensor(params["reason_b_hh"]))
    X = torch.tensor(x, requires_grad=True)
    A = torch.tensor(adj, requires_grad=True)
    _, out = m(X, A)
    wrt = [X, A] + [c.weight for c in m.convs]
    if reason:
        wrt += list(m.rnn.parameters())
    g = torch.autograd.grad(out, wrt, torch.tensor(dy))
    grads = [g[0], g[1], torch.stack(g[2:2 + nl])]
    if reason:
        grads += [g[-4].t(), g[-3].t(), g[-2], g[-1]]
    return out.detach().numpy(), [t.numpy() for t in grads], m


def _jax_grads(res, reason):
    y, dp, dx, da = res
    grads = [dx, da, dp["conv_w"]]
    if reason:
        grads += [dp["reason_w_ih"], dp["reason_w_hh"], dp["reason_b_ih"],
                  dp["reason_b_hh"]]
    return y, grads


def test_plain_scan_matches_the_jax_bf16_scan_at_2_layers():
    """2 layers, H = 32, B = 2, N = 24, every wiring with and without the
    reason-LSTM, ``variant=False``: the port's stack under
    ``compute_dtype='bfloat16'`` against JAX's.  The output and the
    gradients of x, adj, W and the LSTM weights within ``BOUND`` of each
    one's scale (every reading 0: the same bits); the LSTM biases' within
    ``BIAS_BOUND`` (the row sums' order and rounding).  The port's f32
    scan, another function, is more than 5 ``BOUND`` from JAX's bf16 scan
    in dW and d_adj in every wiring, and the scan mode's output lies on the
    bf16 grid."""
    for name, opts, reason, width in WIRINGS:
        x, adj, dy, params, jbf = _jax_stack(2, opts, reason, width)
        y, want = _jax_grads(jbf, reason)
        out, got, m = _port_stack(2, opts, reason, width, params, x, adj, dy,
                                  "bfloat16")
        assert m.mode == SCAN, name
        assert np.array_equal(out, out.astype(jnp.bfloat16).astype(
            np.float32)), name
        assert _scaled(out, y) <= BOUND, name
        for i, (g, w) in enumerate(zip(got, want)):
            bound = BIAS_BOUND if i >= 5 else BOUND
            assert _scaled(g, w) <= bound, (name, i, _scaled(g, w))
        _, f32 = _port_stack(2, opts, reason, width, params, x, adj, dy,
                             None)[:2]
        for i in (1, 2):       # d_adj, dW
            assert _scaled(f32[i], want[i]) > 5 * BOUND, (name, i)


def test_kernel_d_walk_equals_autograd_and_the_config_axis():
    """``_scan_bwd_plain`` (kernel D's reverse walk in plain ops, which the
    card holds kernel D to) against autograd of the plain scan forward, bit
    for bit: live dropout (rate 0.4, a Philox seed), the reason-LSTM on and
    off, ``variant=False``, and GF2's last dropout in f32, 3 layers.  Then
    the config axis of the grouped sweep: ``gcnii_stack_fwd`` in the scan
    mode under ``torch.func.vmap`` over K = 2 stacked configurations at
    rates 0 and 0.4, forward and ``vjp``, equal to each configuration run
    alone bit for bit."""
    from mmdfn_torch.nn.drop_override import make_drop_rate

    nl = 3
    g = torch.Generator().manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=g)
    for reason, variant, last_f32 in ((True, True, False),
                                      (True, False, False),
                                      (False, True, True),
                                      (False, False, False)):
        adj = torch.rand(B, N, N, generator=g) / N
        h, h0 = torch.relu(r(B, N, H)), torch.relu(r(B, N, H))
        W = r(nl, (2 if variant else 1) * H, H) / H ** 0.5
        theta = torch.log(0.5 / torch.arange(1, nl + 1.0) + 1.0)
        lstm = [r(H, 4 * H) / H ** 0.5, r(H, 4 * H) / H ** 0.5,
                0.1 * r(2, 4 * H)]
        seed = torch.tensor([987654321])
        leaves = [adj, h, h0, W] + (lstm if reason else [])
        for t in leaves:
            t.requires_grad_(True)
        res = residual_slabs((B, nl, N, H), SCAN, "cpu")
        kw = dict(alpha=0.1, reason=reason, rate=0.4, seed=seed,
                  relu_masks=None, relu_inputs=None, variant=variant,
                  last_drop_f32=last_f32)
        out = _scan_plain(*leaves[:4], theta,
                          *(lstm if reason else [None] * 3), residuals=res,
                          spmm=None, **kw)
        dy = r(B, N, H)
        want = torch.autograd.grad(out, leaves, dy)
        got = _scan_bwd_plain(adj.detach(), h0.detach(), W.detach(), theta,
                              *(t.detach() for t in lstm), res, dy, **kw)
        for i, w in enumerate(want):
            assert torch.equal(got[i], w), (reason, variant, i)

    # the config axis: K = 2 configurations, one rate each
    K = 2
    adj = torch.rand(K, B, N, N, generator=g) / N
    h, h0 = torch.relu(r(K, B, N, H)), torch.relu(r(K, B, N, H))
    W = r(K, nl, 2 * H, H) / H ** 0.5
    ih, hh, b = (r(K, H, 4 * H) / H ** 0.5, r(K, H, 4 * H) / H ** 0.5,
                 0.1 * r(K, 2, 4 * H))
    theta = torch.log(0.5 / torch.arange(1, nl + 1.0) + 1.0)
    dy = r(K, B, N, H)
    seed = torch.tensor([1234])
    rates = make_drop_rate([0.0, 0.4])

    def one(adj, h, h0, W, ih, hh, b, dy, rate):
        f = lambda *a: gcnii_stack_fwd(*a[:4], theta, *a[4:], alpha=0.1,
                                       reason=True, rate=rate, seed=seed,
                                       mode=SCAN)
        out, vjp = torch.func.vjp(f, adj, h, h0, W, ih, hh, b)
        return out, vjp(dy)
    got = torch.func.vmap(one, randomness="same")(
        adj, h, h0, W, ih, hh, b, dy, rates)
    for k in range(K):
        alone = one(adj[k], h[k], h0[k], W[k], ih[k], hh[k], b[k], dy[k],
                    [0.0, 0.4][k])
        assert torch.equal(got[0][k], alone[0])
        for gk, a in zip(got[1], alone[1]):
            assert torch.equal(gk[k], a)


def test_scan_output_matches_jax_on_the_bf16_grid_at_16_layers():
    """16 layers with the reason-LSTM (the flagship's wiring) and MM_GCN2's
    wiring: every element of the scan mode's output is bf16-representable
    (JAX casts a bf16 carry back to f32), and the output and every
    gradient but the LSTM biases' are within ``BOUND`` of the scale of
    JAX's bf16 scan (the readings are 0)."""
    for name, opts, reason, width in (WIRINGS[0], WIRINGS[4]):
        x, adj, dy, params, jbf = _jax_stack(16, opts, reason, width,
                                             seed=3)
        y, want = _jax_grads(jbf, reason)
        out, got, _ = _port_stack(16, opts, reason, width, params, x, adj,
                                  dy, "bfloat16")
        assert np.array_equal(out, out.astype(jnp.bfloat16).astype(
            np.float32)), name
        assert _scaled(out, y) <= BOUND, name
        for i, (g, w) in enumerate(zip(got[:5], want[:5])):
            assert _scaled(g, w) <= BOUND, (name, i, _scaled(g, w))


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=3, min_len=3,
                                  max_len=12, seed=4)
    return path


def _against_jax(pickle_path, kw, n_steps=3, fast=True, logp_atol=1e-4,
                 loss_rtol=1e-5):
    """The port's Trainer on its seeded weights bridged into JAX's tree,
    against the JAX Trainer's model at dropout 0, B = 2, L <= 12: the
    first batch's log-probs (the served forward) within ``logp_atol`` and
    ``n_steps`` losses within ``loss_rtol`` relative.  Returns the port's
    trainer."""
    cfg, jcfg = ExperimentConfig(**kw), JConfig(**kw)
    if fast:
        cfg, jcfg = cfg.with_tpu_fast(), jcfg.with_tpu_fast()
    tr = Trainer(cfg, device="cpu")
    jtr = JTrainer(jcfg)
    shapes = jax.eval_shape(lambda: jtr._init_variables(
        jax.random.PRNGKey(0), jtr._example_inputs()))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = state_dict_to_params(
        {k: v.numpy() for k, v in tr.model.state_dict().items()}, template)
    state = (params, fast_jit(jtr.tx.init)(params))

    @fast_jit
    def jstep(state, inputs, key):
        p, opt = state
        logp = jtr._apply_model(p, inputs, True, None)
        loss, grads = jax.value_and_grad(lambda q: jtr._loss(
            jtr._apply_model(q, inputs, False, {"dropout": key}),
            inputs["label"], inputs["umask"]))(p)
        updates, opt = jtr.tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss, logp

    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    batches = list(BucketBatcher(dias, 2, 2, (12,)).epoch(0))[:n_steps]
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        state, jloss, jlogp = jstep(state, j_prepare_inputs(jtr.cfg, b),
                                    jax.random.PRNGKey(i))
        inputs = tr._prepare(b)
        if i == 0:
            with torch.no_grad():
                logp = tr._forward(inputs).numpy()
            valid = b.umask > 0
            np.testing.assert_allclose(logp[valid], np.asarray(jlogp)[valid],
                                       atol=logp_atol)
        jlosses.append(float(jloss))
        losses.append(float(tr.train_step(inputs, seed=i)[0]))
    np.testing.assert_allclose(losses, jlosses, rtol=loss_rtol)
    return tr


def _modes(model):
    return {s.mode for s in model.modules() if isinstance(s, GCNIIStack)}


@pytest.mark.parametrize("graph_type", ["GF2", "DeepGCN"])
def test_family_under_tpu_fast_matches_jax(pickle_path, graph_type):
    """GF2 (MM_GCN2's wiring, its fixed 64 layers) and DeepGCN (three
    GCNII stacks, 2 layers, the reason-LSTM) under ``with_tpu_fast()``,
    which JAX runs as its bf16 layer scan, at dropout 0: the port's stacks
    in the scan mode, the served forward's log-probs within 5e-4 of JAX's
    and three Adam steps' losses within 1e-4 relative.  The stacks compute
    JAX's bits from the same inputs (the tests above), but their inputs
    come from f32 encoders and graphs summed in another order (~1e-7
    apart), and where that rounds an entry's bf16 to the neighbouring
    value, the step of 2^-8 it takes moves the log-probs: measured 1.25e-4
    (DeepGCN; 4 of 132) and the second and third losses 3.5e-5 (GF2)."""
    kw = dict(dataset="IEMOCAP", graph_type=graph_type, dropout=0.0,
              batch_size=2, class_weight=True, buckets=(12,),
              Deep_GCN_nlayers=2, reason_flag=graph_type == "DeepGCN")
    tr = _against_jax(pickle_path, kw, logp_atol=5e-4, loss_rtol=1e-4)
    assert _modes(tr.model) == {SCAN}


def test_flagship_with_gcn_compute_dtype_alone_matches_jax(pickle_path):
    """The flagship (GDF with the reason-LSTM, 2 layers) with
    ``gcn_compute_dtype='bfloat16'`` and no Pallas backend: JAX's bf16
    layer scan, the port's scan mode; log-probs within 1e-4, three steps'
    losses within 1e-5 relative."""
    kw = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              Deep_GCN_nlayers=2, dropout=0.0, batch_size=2,
              class_weight=True, buckets=(12,),
              gcn_compute_dtype="bfloat16")
    tr = _against_jax(pickle_path, kw, fast=False)
    assert _modes(tr.model) == {SCAN}


def test_transfer_dtype_bfloat16_step_matches_jax(pickle_path):
    """``transfer_dtype='bfloat16'`` (``mmdfn_tpu/train/trainer.py:
    106-107``): the features arrive rounded to bf16 and widened, and one
    Trainer step of the f32 flagship (2 layers) on them gives JAX's log-
    probs within 1e-4 and its loss within 1e-5 relative."""
    kw = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              Deep_GCN_nlayers=2, dropout=0.0, batch_size=2,
              class_weight=True, buckets=(12,), transfer_dtype="bfloat16")
    tr = _against_jax(pickle_path, kw, n_steps=1, fast=False)
    b = next(iter(BucketBatcher(
        IEMOCAPDataset(pickle_path, train=True).dialogues(), 2, 2,
        (12,)).epoch(0)))
    text = tr._prepare(b)["text"]
    assert text.dtype == torch.float32
    assert torch.equal(text, torch.from_numpy(b.text).to(
        torch.bfloat16).float())
    assert _modes(tr.model) == {"f32"}


def test_nonvariant_mmgcn_under_tpu_fast_steps_and_serves():
    """``MMGCN(variant=False)`` under the preset's knobs (``gcn_backend=
    'pallas'``, ``compute_dtype='bfloat16'``): JAX's fused kernel takes
    the variant's update only, so the stack runs the scan mode on its (H,
    H) weights unfolded; a training forward with live dropout and its
    backward reach every weight with finite gradients, and the served
    forward lies on the bf16 grid's image (finite, the stack's output
    bf16-representable)."""
    torch.manual_seed(0)
    m = MMGCN(D, 2, H, reason_flag=True, variant=False, dropout=0.4,
              backend="pallas", compute_dtype="bfloat16")
    assert m.graph_net.mode == SCAN
    assert m.graph_net.convs[0].weight.shape == (H, H)
    g = torch.Generator().manual_seed(3)
    stack = m.graph_net
    x = torch.randn(B, N, stack.fcs[0].in_features, generator=g)
    adj = torch.rand(B, N, N, generator=g) / N
    _, out = stack(x, adj, train=True, generator=g)
    out.square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in stack.parameters())
    with torch.no_grad():
        _, served = stack(x, adj)
    assert torch.isfinite(served).all()
    assert torch.equal(served, served.to(torch.bfloat16).float())
