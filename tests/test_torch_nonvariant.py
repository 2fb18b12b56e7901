"""The original GCNII update (``variant=False``) in the port against the
JAX package: the plain stack and the folded one (kernels B and D's path)
against ``gcnii_stack_fused(variant=False)``, the fold's gradients, the
config axis under ``vmap``, the module's weight cache and the
node-sharded product's path.  The models on it:
``tests/test_torch_nonvariant_models.py``."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.nn.gcn import gcnii_conv as j_gcnii_conv
from mmdfn_tpu.ops import gcnii_stack_fused

from mmdfn_torch.nn.gcn import GCNIIStack, gcnii_conv
from mmdfn_torch.ops import fold_weights, gcnii_stack_fwd, gcnii_stack_plain
from mmdfn_torch.ops import gcnii as gcnii_ops


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


ALPHA, NL, H, N, B = 0.2, 3, 16, 12, 2


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _stack_inputs(seed):
    rng = np.random.default_rng(seed)
    umask = (np.arange(N)[None] < np.array([[N], [N - 4]])).astype(np.float32)
    adj = rng.random((B, N, N)).astype(np.float32) / N
    adj *= umask[:, :, None] * umask[:, None, :]
    h = np.maximum(rng.standard_normal((B, N, H)), 0).astype(np.float32)
    W = (rng.standard_normal((NL, H, H)) * 0.3).astype(np.float32)
    theta = np.log(0.5 / np.arange(1, NL + 1) + 1.0).astype(np.float32)
    lstm = [(rng.standard_normal(s) * 0.2).astype(np.float32)
            for s in ((H, 4 * H), (H, 4 * H), (4 * H,))]
    return umask, adj, h, W, theta, lstm


@pytest.mark.parametrize("reason", [True, False])
def test_nonvariant_stack_matches_jax_fused_kernel(reason):
    """The unfolded plain stack and the folded one (what kernels B and D
    run) against JAX's fused kernel in interpret mode, with and without
    the reason-LSTM."""
    umask, adj, h, W, theta, lstm = _stack_inputs(int(reason))
    want = np.asarray(gcnii_stack_fused(
        *map(jnp.asarray, (adj, h, h, W, theta, *lstm)), alpha=ALPHA,
        variant=False, reason=reason, interpret=True))
    args = (T(adj), T(h), T(h), T(W), T(theta), *map(T, lstm))
    plain = gcnii_stack_plain(*args, alpha=ALPHA, reason=reason,
                              variant=False).numpy()
    folded = gcnii_stack_fwd(*args, alpha=ALPHA, reason=reason,
                             variant=False).numpy()
    valid = umask > 0
    np.testing.assert_allclose(plain[valid], want[valid], atol=1e-5)
    np.testing.assert_allclose(folded[valid], want[valid], atol=1e-5)
    # one layer: gcnii_conv against JAX's, both wirings
    for variant, w in ((False, W[0]), (True, np.concatenate([W[0], W[1]]))):
        got = gcnii_conv(T(h), T(adj), T(h), T(w), T(theta[0]), ALPHA,
                         variant).numpy()
        ref = np.asarray(j_gcnii_conv(jnp.asarray(h), jnp.asarray(adj),
                                      jnp.asarray(h), jnp.asarray(w),
                                      theta[0], ALPHA, variant))
        np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_fold_gradients_equal_the_unfolded_plain_stack(rate):
    """Through the fold, the training Function (kernel B's training mode
    and kernel D's plain versions on the CPU) gives the unfolded plain
    stack's output and, by autograd through the fold, its gradients of
    every operand, live dropout included."""
    umask, adj, h, W, theta, lstm = _stack_inputs(2)
    seed = torch.tensor([99], dtype=torch.int64) if rate else None
    leaves = lambda: [T(a.copy()).requires_grad_()
                      for a in (adj, h, h, W, *lstm)]
    dy = torch.randn(B, N, H, generator=torch.Generator().manual_seed(0))
    outs = []
    for fn in (gcnii_stack_fwd, gcnii_stack_plain):
        a = leaves()
        out = fn(*a[:4], T(theta), *a[4:], alpha=ALPHA, reason=True,
                 rate=rate, seed=seed, variant=False)
        outs.append((out, torch.autograd.grad(out, a, dy)))
    (got, got_g), (want, want_g) = outs
    assert "GCNIIStackTrain" in type(got.grad_fn).__name__
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()),
                                   rtol=0)


def test_nonvariant_config_axis_is_one_call_equal_to_solo_runs(monkeypatch):
    """K = 2 non-variant configurations under ``torch.func.vmap``: one
    call of the training Function (its fold on the config axis), each
    configuration's output and gradients equal to its run alone."""
    g = torch.Generator().manual_seed(5)
    K = 2
    umask, adj, h, W, theta, lstm = _stack_inputs(3)
    calls = []
    inner = gcnii_ops._forward
    monkeypatch.setattr(gcnii_ops, "_forward", lambda *a, **kw: (
        calls.append(a[3].shape), inner(*a, **kw))[1])
    stack = lambda t: torch.stack([t, t * 0.9 + 0.01])
    args = [stack(T(a)).requires_grad_() for a in (adj, h, W, *lstm)]
    f = lambda adj, h, W, ih, hh, b: gcnii_stack_fwd(
        adj, h, h, W, T(theta), ih, hh, b, alpha=ALPHA, reason=True,
        variant=False)
    dy = torch.randn(K, B, N, H, generator=g)
    out = torch.func.vmap(f)(*args)
    grads = torch.autograd.grad(out, args, dy)
    assert calls == [(K, NL, 2 * H, H)], calls
    for k in range(K):
        a = [t[k].detach().requires_grad_() for t in args]
        want = f(*a)
        want_g = torch.autograd.grad(want, a, dy[k])
        assert torch.equal(out[k], want)
        for x, y in zip(grads, want_g):
            assert torch.equal(x[k], y)


def test_nonvariant_weight_cache_follows_weight_writes():
    """Serving keeps the stacked weights and their fold; an in-place write
    (an optimiser step) rebuilds both, and with autograd on the fold is
    built inside the graph, so gradients reach each layer's (H, H)
    weight."""
    umask, adj, h, W, theta, lstm = _stack_inputs(4)
    pm = GCNIIStack(H, NL, H, alpha=ALPHA, reason_flag=True, variant=False)
    assert pm.convs[0].weight.shape == (H, H)
    X, A = T(h), T(adj)
    with torch.inference_mode():
        first = pm._packed()
        assert first[1] is not None and pm._packed() is first
        _, h1 = pm(X, A)
        pm.convs[1].weight.mul_(0.5)
        second = pm._packed()
        assert second is not first
        torch.testing.assert_close(second[1],
                                   fold_weights(second[0], ALPHA), rtol=0,
                                   atol=0)
        _, h2 = pm(X, A)
    with torch.no_grad():
        _, fresh = pm(X, A)
    assert torch.equal(h2, fresh) and not torch.equal(h1, h2)
    _, hg = pm(X, A)
    hg.sum().backward()
    assert all(c.weight.grad is not None for c in pm.convs)


def test_nonvariant_stack_on_the_sharded_product_path_matches():
    """With ``spmm`` (the node-sharded product's place) the stack runs its
    plain version, which computes the original update too: the same
    output as the folded path."""
    umask, adj, h, W, theta, lstm = _stack_inputs(6)
    pm = GCNIIStack(H, NL, H, alpha=ALPHA, variant=False)
    pm.reset_parameters(torch.Generator().manual_seed(2))
    X, A = T(h), T(adj)
    with torch.no_grad():
        _, want = pm(X, A)
        pm.spmm = lambda a, x: a @ x
        _, got = pm(X, A)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
