"""Kernel D's plain version (``gcnii_stack_bwd_plain``) against the JAX
package (``jax.vjp`` of the f32 ``GCNIIStack`` scan, and of
``gcnii_stack_train`` in interpret mode) and against autograd through the
port's plain forward with live dropout; and the Philox bits that kernels B
and D draw."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.graph.adjacency import gcnii_block_adjacency
from mmdfn_tpu.nn.gcn import GCNIIStack as JGCNIIStack
from mmdfn_tpu.ops.pallas_gcnii_train import gcnii_stack_train

from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.ops import (gcnii_stack_bwd_plain, gcnii_stack_fwd,
                             gcnii_stack_plain, philox, plain_ops)
from mmdfn_torch.ops.gcnii import (RESIDUALS, RESIDUALS_BF16, _lstm_step,
                                   interleave_gates)
from mmdfn_torch.weights import gcnii_from_jax


# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vjp(f, args, dy):
    """``f(*args)`` and its vjp of ``dy``, in one compile."""
    def run(args, dy):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(dy)
    return fast_jit(run)(args, dy)


ALPHA, NL, H, N, B, D = 0.2, 4, 32, 12, 2, 24


def _inputs(seed, reason):
    rng = np.random.default_rng(seed)
    lengths = np.array([N, N - 4])
    umask = (np.arange(N)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.standard_normal((B, N, D)) * umask[..., None]).astype(np.float32)
    adj = np.array(fast_jit(gcnii_block_adjacency)(jnp.asarray(x),
                                                   jnp.asarray(umask)))
    jm = JGCNIIStack(nlayers=NL, nhidden=H, alpha=ALPHA, reason_flag=reason)
    params = fast_jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                               jnp.asarray(adj))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    theta = np.log(0.5 / np.arange(1, NL + 1) + 1.0).astype(np.float32)
    dh = rng.standard_normal((B, N, H)).astype(np.float32)
    return rng, x, adj, jm, params, theta, dh


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("reason", [True, False])
def test_module_gradients_match_jax_vjp_of_the_scan(reason):
    """The port's GCNIIStack in training at dropout 0 (its layer loop is the
    autograd Function, whose CPU backward is gcnii_stack_bwd_plain) against
    jax.vjp of the f32 scan, for every parameter and both inputs."""
    rng, x, adj, jm, params, theta, dh = _inputs(0, reason)
    f = lambda p, xx, aa: jm.apply({"params": p}, xx, aa)[1]
    out, (jp, jx, jadj) = _vjp(f, (params, jnp.asarray(x), jnp.asarray(adj)),
                               jnp.asarray(dh))

    pm = GCNIIStack(D, NL, H, alpha=ALPHA, reason_flag=reason, dropout=0.0)
    pm.load_state_dict(gcnii_from_jax(params))
    X = torch.from_numpy(x).requires_grad_()
    A = torch.from_numpy(adj).requires_grad_()
    _, h = pm(X, A, train=True)
    assert h.grad_fn is not None and "GCNIIStackTrain" in type(
        h.grad_fn).__name__
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(out),
                               atol=1e-4)
    h.backward(torch.from_numpy(dh))
    pairs = [(X.grad, jx), (A.grad, jadj),
             (torch.stack([c.weight.grad for c in pm.convs]), jp["conv_w"]),
             (pm.fcs[0].weight.grad.t(), jp["fc_in"]["kernel"]),
             (pm.fcs[0].bias.grad, jp["fc_in"]["bias"])]
    if reason:
        r = pm.rnn
        pairs += [(r.weight_ih_l0.grad.t(), jp["reason_w_ih"]),
                  (r.weight_hh_l0.grad.t(), jp["reason_w_hh"]),
                  (r.bias_ih_l0.grad, jp["reason_b_ih"]),
                  (r.bias_hh_l0.grad, jp["reason_b_hh"])]
    for got, want in pairs:
        # f32 over 4 layers; only the summation order differs
        assert _rel_err(got.numpy(), want) < 1e-4


def _residuals(adj, h, h0, W, theta, lstm, reason, rate=0.0, seed=None,
               bf16=False):
    res = [torch.zeros(B, NL, N, H, dtype=torch.bfloat16 if bf16 else None)
           for _ in (RESIDUALS_BF16 if bf16 else RESIDUALS)]
    out = gcnii_stack_fwd(adj, h, h0, W, theta, *lstm, alpha=ALPHA,
                          reason=reason, rate=rate, seed=seed, residuals=res,
                          bf16=bf16)
    return out, res


def test_bwd_plain_against_the_jax_train_kernel_at_rate_0():
    rng, x, adj, jm, params, theta, dh = _inputs(1, True)
    h = np.maximum(x @ params["fc_in"]["kernel"] + params["fc_in"]["bias"],
                   0.0).astype(np.float32)
    h0 = (h * rng.uniform(0.5, 1.5, h.shape)).astype(np.float32)
    W = params["conv_w"]
    lb = params["reason_b_ih"] + params["reason_b_hh"]
    lstm = (params["reason_w_ih"], params["reason_w_hh"], lb)
    f = lambda a, he, hz, w, ih, hh, b: gcnii_stack_train(
        a, he, hz, w, jnp.asarray(theta), ih, hh, b, alpha=ALPHA,
        reason=True, rate=0.0, seed=0, interpret=True)
    _, want = _vjp(f, tuple(map(jnp.asarray, (adj, h, h0, W, *lstm))),
                   jnp.asarray(dh))

    T = torch.from_numpy
    _, res = _residuals(T(adj), T(h), T(h0), T(W), T(theta),
                        tuple(map(T, lstm)), True, bf16=True)
    got = gcnii_stack_bwd_plain(T(adj), T(h0), T(W), T(theta),
                                *map(T, lstm), res, T(dh), alpha=ALPHA,
                                reason=True, bf16=True)
    # (d_adj, d_h, d_h0, dW, dW_ih, dW_hh, db) against the JAX order
    # (adj, h_entry, h0, W, ih, hh, b).  The bf16 mode computes that
    # kernel's function, its backward recomputing from the bf16 residuals:
    # only f32 summation order differs.  d_adj, d_h0 and dW are rounded to
    # bf16 on both sides, so each element within one bf16 step (2^-7 of
    # it); the rest within 1e-4 of each gradient's scale (measured 1.1e-7).
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        s = np.abs(w).max()
        if i in (0, 2, 3):
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-6 * s)
        else:
            assert _rel_err(g, w) < 1e-4


@pytest.mark.parametrize("reason", [True, False])
def test_bwd_plain_with_live_dropout_equals_autograd(reason):
    rng, x, adj, jm, params, theta, dh = _inputs(2, reason)
    T = torch.from_numpy
    g = torch.Generator().manual_seed(2)
    h = torch.relu(torch.randn(B, N, H, generator=g)).requires_grad_()
    h0 = torch.relu(torch.randn(B, N, H, generator=g)).requires_grad_()
    A = T(adj).requires_grad_()
    W = T(params["conv_w"]).requires_grad_()
    lstm = ((T(params["reason_w_ih"]), T(params["reason_w_hh"]),
             T(params["reason_b_ih"] + params["reason_b_hh"]))
            if reason else (None, None, None))
    for t in lstm:
        if t is not None:
            t.requires_grad_()
    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64)
    ins = [A, h, h0, W] + [t for t in lstm if t is not None]
    with plain_ops():
        out = gcnii_stack_fwd(A, h, h0, W, T(theta), *lstm, alpha=ALPHA,
                              reason=reason, rate=0.4, seed=seed)
    want = torch.autograd.grad(out, ins, T(dh))
    with torch.no_grad():
        out2, res = _residuals(A, h, h0, W, T(theta), lstm, reason, 0.4,
                               seed)
    assert torch.equal(out2, out.detach())
    got = gcnii_stack_bwd_plain(A.detach(), h0.detach(), W.detach(),
                                T(theta), *(t if t is None else t.detach()
                                            for t in lstm), res, T(dh),
                                alpha=ALPHA, reason=reason, rate=0.4,
                                seed=seed)
    got = [got[0], got[1], got[2], got[3]] + (list(got[4:]) if reason
                                              else [])
    for a, b in zip(got, want):
        assert _rel_err(a.numpy(), b.numpy()) < 1e-5
    # the dropout is live: the same seed drops the same elements, another
    # seed others
    with torch.no_grad():
        other = gcnii_stack_plain(A, h, h0, W, T(theta), *lstm, alpha=ALPHA,
                                  reason=reason, rate=0.4,
                                  seed=seed + 1)
    assert not torch.equal(other, out2)


@pytest.mark.parametrize("reason", [True, False])
def test_bwd_plain_at_given_relu_decisions(reason):
    """The plain backward's and the plain forward's ReLU decisions can be
    given: their own decisions give the same bits as without them, and the
    opposite decision on one passing element changes the gradients and the
    output."""
    rng, x, adj, jm, params, theta, dh = _inputs(3, reason)
    T = torch.from_numpy
    g = torch.Generator().manual_seed(3)
    h = torch.relu(torch.randn(B, N, H, generator=g))
    h0 = torch.relu(torch.randn(B, N, H, generator=g))
    W = T(params["conv_w"])
    lstm = ((T(params["reason_w_ih"]), T(params["reason_w_hh"]),
             T(params["reason_b_ih"] + params["reason_b_hh"]))
            if reason else (None, None, None))
    _, res = _residuals(T(adj), h, h0, W, T(theta), lstm, reason)
    masks = []
    for l in range(NL):
        h1 = (_lstm_step(res[0][:, l], res[1][:, l], res[2][:, l], *lstm)[0]
              if reason else res[0][:, l])
        hi = T(adj) @ h1
        th = T(theta)[l]
        masks.append(th * (hi @ W[l, :H] + h0 @ W[l, H:]) + (1.0 - th) * (
            (1.0 - ALPHA) * hi + ALPHA * h0) > 0.0)
    run = lambda m: gcnii_stack_bwd_plain(
        T(adj), h0, W, T(theta), *lstm, res, T(dh), alpha=ALPHA,
        reason=reason, relu_masks=m)
    want = run(None)
    for a, b in zip(run(masks), want):
        assert torch.equal(a, b)
    flipped = [m.clone() for m in masks]
    flipped[NL - 1][0, 0, int(masks[NL - 1][0, 0].int().argmax())] = False
    assert not torch.equal(run(flipped)[2], want[2])
    fwd = lambda m: gcnii_stack_plain(T(adj), h, h0, W, T(theta), *lstm,
                                      alpha=ALPHA, reason=reason,
                                      relu_masks=m)
    assert torch.equal(fwd(masks), fwd(None))
    assert not torch.equal(fwd(flipped), fwd(None))


def test_philox_known_answer_and_keep_fraction():
    z = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in philox.philox4x32(z, z, z, z, z, z)]
    # Random123's known-answer vector for Philox4x32-10, key 0 counter 0
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    words = [int(w) for w in philox.philox4x32(f, f, f, f, f, f)]
    assert words == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert philox.threshold(0.4) == int(0.6 * 2 ** 32)
    assert philox.threshold(0.0) == 2 ** 32 - 1

    seed = torch.tensor([20211016], dtype=torch.int64)
    rate = 0.4
    keep = philox.keep_mask(seed, rate, 8, 3, 125, 100)     # 1e5 draws
    n = keep.numel()
    frac = float(keep.float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(frac - (1 - rate)) < 4 * sigma
    # another layer draws other bits
    assert not torch.equal(keep, philox.keep_mask(seed, rate, 8, 4, 125, 100))


def test_gate_interleave_round_trips_and_gives_the_lstm_step():
    """Kernel B's LSTM product reads [W_ih; W_hh; b] with the gate columns
    interleaved (column 4c + u is gate u of channel c): undoing the
    interleave gives the stacked weights back, and the cell computed on the
    product's 4-wide chunks, as the kernel's epilogue does, is the plain
    ``_lstm_step``."""
    rng = np.random.default_rng(8)
    Hs, rows = 6, (3, 5)
    f32 = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    ih, hh, b = f32(Hs, 4 * Hs), f32(Hs, 4 * Hs), f32(4 * Hs)
    wl = interleave_gates(ih, hh, b)
    assert wl.shape == (2 * Hs + 1, 4 * Hs)
    back = wl.view(2 * Hs + 1, Hs, 4).transpose(1, 2).reshape(
        2 * Hs + 1, 4 * Hs)
    assert torch.equal(back, torch.cat([ih, hh, b[None]]))

    h, lh, lc = f32(*rows, Hs), f32(*rows, Hs), f32(*rows, Hs)
    gates = torch.cat([h, lh, torch.ones(*rows, 1)], -1) @ wl
    chunk = gates.view(*rows, Hs, 4)          # one channel's i, f, g, o
    i, f = torch.sigmoid(chunk[..., 0]), torch.sigmoid(chunk[..., 1])
    g, o = torch.tanh(chunk[..., 2]), torch.sigmoid(chunk[..., 3])
    lc1 = f * lc + i * g
    want_h1, want_lc1, _ = _lstm_step(h, lh, lc, ih, hh, b)
    # f32; the bias is summed with the product here, after it there
    torch.testing.assert_close(lc1, want_lc1, atol=1e-5, rtol=0)
    torch.testing.assert_close(o * torch.tanh(lc1), want_h1, atol=1e-5,
                               rtol=0)
