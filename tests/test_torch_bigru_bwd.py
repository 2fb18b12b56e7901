"""Kernel C's plain version (``bigru_layer_bwd_plain``) against the JAX
package's ``_bigru_bwd`` (through ``jax.vjp`` of ``fused_bigru_layer`` in
interpret mode) and against autograd through the port's plain forward; and
the training forward of the port's BiRNN."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.ops.pallas_rnn import fused_bigru_layer

from mmdfn_torch.nn.rnn import BiRNN
from mmdfn_torch.ops import (bigru_layer_bwd, bigru_layer_bwd_plain,
                             bigru_layer_fwd, bigru_layer_plain, plain_ops)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, B, L = 32, 3, 9


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.2, 0.2, s).astype(np.float32)
    xg_f = rng.standard_normal((B, L, 3 * H)).astype(np.float32)
    xg_b = rng.standard_normal((B, L, 3 * H)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.35).astype(np.float32)   # holes
    mask[:, 0] = 1.0
    mask[2, 6:] = 0.0                                       # a padded tail
    dy = [rng.standard_normal((B, L, H)).astype(np.float32) for _ in range(2)]
    return (xg_f, xg_b, u(H, 3 * H), u(3 * H), u(H, 3 * H), u(3 * H),
            mask), dy


def _port_bwd(args, dy):
    T = [torch.from_numpy(a) for a in args]
    ys = bigru_layer_plain(*T)
    return bigru_layer_bwd_plain(*T, *ys, *map(torch.from_numpy, dy))


def test_bwd_plain_matches_jax_vjp_of_the_fused_kernel():
    args, dy = _inputs()
    got = _port_bwd(args, dy)
    xg_f, xg_b, wf, bf, wb, bb, mask = map(jnp.asarray, args)
    f = lambda *a: fused_bigru_layer(*a, mask, interpret=True)
    _, vjp = jax.vjp(f, xg_f, xg_b, wf, bf, wb, bb)
    want = vjp(tuple(map(jnp.asarray, dy)))
    # f32 BPTT over 9 steps; only the summation order differs
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_bwd_plain_matches_autograd_and_the_autograd_function():
    args, dy = _inputs(1)
    got = _port_bwd(args, dy)
    T = [torch.from_numpy(a).requires_grad_(i < 6)
         for i, a in enumerate(args)]
    dyt = tuple(map(torch.from_numpy, dy))
    with plain_ops():                    # autograd through the plain loop
        ys = bigru_layer_fwd(*T)
    want = torch.autograd.grad(ys, T[:6], dyt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    # outside plain_ops the wrapper goes through BiGRULayer, whose backward
    # on CPU tensors is the plain backward
    ys = bigru_layer_fwd(*T)
    assert ys[0].grad_fn is not None
    via_fn = torch.autograd.grad(ys, T[:6], dyt)
    for a, b in zip(got, via_fn):
        assert torch.equal(a, b)


def test_nan_in_a_masked_frame_leaves_every_gradient_finite():
    args, dy = _inputs(2)
    xg_f, xg_b, wf, bf, wb, bb, mask = args
    mask = mask.copy()
    mask[1, 4] = 0.0
    xg_f, xg_b = xg_f.copy(), xg_b.copy()
    xg_f[1, 4] = np.nan
    xg_b[1, 4] = np.inf
    poisoned = (xg_f, xg_b, wf, bf, wb, bb, mask)
    got = _port_bwd(poisoned, dy)
    clean = _port_bwd((args[0], args[1], wf, bf, wb, bb, mask), dy)
    for a, c in zip(got, clean):
        assert torch.isfinite(a).all()
    # the masked frame's own gradient is exactly zero, the rest unchanged
    for a, c in zip(got, clean):
        torch.testing.assert_close(a, c, atol=0, rtol=0)


def test_launch_counts_stay_zero_on_the_cpu():
    args, dy = _inputs(3)
    before = (bigru_layer_fwd.launches, bigru_layer_bwd.launches)
    T = [torch.from_numpy(a).requires_grad_(i < 6)
         for i, a in enumerate(args)]
    ys = bigru_layer_fwd(*T)
    (ys[0].sum() + ys[1].sum()).backward()
    assert (bigru_layer_fwd.launches, bigru_layer_bwd.launches) == before


def test_birnn_train_dropout():
    torch.manual_seed(0)
    rnn = BiRNN(20, H, dropout=0.5)
    x = torch.randn(2, 7, 20)
    umask = torch.ones(2, 7)
    ev = rnn(x, umask)
    # rate 0 in training is the serve forward; a live rate draws from the
    # generator only (the same seed gives the same output)
    rnn.dropout = 0.0
    torch.testing.assert_close(rnn(x, umask, train=True), ev, atol=0, rtol=0)
    rnn.dropout = 0.5
    a = rnn(x, umask, train=True, generator=torch.Generator().manual_seed(1))
    b = rnn(x, umask, train=True, generator=torch.Generator().manual_seed(1))
    c = rnn(x, umask, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bwd_plain_with_the_saved_hg_matches_the_recompute_and_jax():
    """Kernel C's contract: the backward from the forward's saved hg gives
    the gradients of the backward that recomputes the gates, and of the
    JAX ``_bigru_bwd``."""
    args, dy = _inputs(4)
    T = [torch.from_numpy(a) for a in args]
    ys_f, ys_b, hg_f, hg_b = bigru_layer_plain(*T, with_hg=True)
    dyt = tuple(map(torch.from_numpy, dy))
    saved = bigru_layer_bwd_plain(*T, ys_f, ys_b, *dyt, hg_f, hg_b)
    recomputed = bigru_layer_bwd_plain(*T, ys_f, ys_b, *dyt)
    for a, b in zip(saved, recomputed):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    xg_f, xg_b, wf, bf, wb, bb, mask = map(jnp.asarray, args)
    f = lambda *a: fused_bigru_layer(*a, mask, interpret=True)
    _, vjp = jax.vjp(f, xg_f, xg_b, wf, bf, wb, bb)
    want = vjp(tuple(map(jnp.asarray, dy)))
    # f32 BPTT over 9 steps; only the summation order differs
    for a, b in zip(saved, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_bigru_layer_function_on_the_cpu_gives_autograds_gradients():
    """BiGRULayer (plain forward with hg, plain backward from it) against
    autograd through the plain forward."""
    from mmdfn_torch.ops.bigru import BiGRULayer

    args, dy = _inputs(5)
    T = [torch.from_numpy(a).requires_grad_(i < 6)
         for i, a in enumerate(args)]
    dyt = tuple(map(torch.from_numpy, dy))
    ys = BiGRULayer.apply(*T)
    want_ys = bigru_layer_plain(*T)
    for a, b in zip(ys, want_ys):
        assert torch.equal(a, b)
    got = torch.autograd.grad(ys, T[:6], dyt)
    want = torch.autograd.grad(want_ys, T[:6], dyt)
    # f32; autograd sums dW over steps in another order
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
