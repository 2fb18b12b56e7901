"""Kernel B (the GCNII stack forward) and the port's GCNIIStack, held
against the JAX package's three functions on the same numpy inputs."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.graph.adjacency import gcnii_block_adjacency
from mmdfn_tpu.nn.gcn import GCNIIStack as JGCNIIStack
from mmdfn_tpu.ops import gcnii_stack_fused
from mmdfn_tpu.ops.pallas_gcnii_train import gcnii_stack_train

from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.ops import gcnii_stack_fwd
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


ALPHA, NL, H = 0.2, 16, 100


def _inputs(seed=0, B=2, N=12, D=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([N, N - 4])[:B]
    umask = (np.arange(N)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.standard_normal((B, N, D)) * umask[..., None]).astype(np.float32)
    adj = np.array(fast_jit(gcnii_block_adjacency)(jnp.asarray(x),
                                                   jnp.asarray(umask)))
    jm = JGCNIIStack(nlayers=NL, nhidden=H, alpha=ALPHA, reason_flag=True)
    params = fast_jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                               jnp.asarray(adj))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    h = np.maximum(x @ params["fc_in"]["kernel"] + params["fc_in"]["bias"],
                   0.0).astype(np.float32)
    theta = np.log(0.5 / np.arange(1, NL + 1) + 1.0).astype(np.float32)
    return x, adj, umask, jm, params, h, theta


def _plain(adj, h, params, theta, bf16=False):
    T = torch.from_numpy
    return gcnii_stack_fwd(
        T(adj), T(h), T(h), T(params["conv_w"]), T(theta),
        T(params["reason_w_ih"]), T(params["reason_w_hh"]),
        T(params["reason_b_ih"] + params["reason_b_hh"]),
        alpha=ALPHA, reason=True, bf16=bf16).numpy()


def test_plain_matches_jax_fused_kernel_and_scan():
    x, adj, umask, jm, params, h, theta = _inputs()
    got = _plain(adj, h, params, theta)
    want = gcnii_stack_fused(
        jnp.asarray(adj), jnp.asarray(h), jnp.asarray(h),
        jnp.asarray(params["conv_w"]), jnp.asarray(theta),
        jnp.asarray(params["reason_w_ih"]), jnp.asarray(params["reason_w_hh"]),
        jnp.asarray(params["reason_b_ih"] + params["reason_b_hh"]),
        alpha=ALPHA, reason=True, interpret=True)
    valid = umask > 0
    # 16 chained f32 layers; only the summation order differs
    np.testing.assert_allclose(got[valid], np.asarray(want)[valid], atol=1e-4)

    # the module: fc_in + the scan over layers, on bridged weights
    _, jh = fast_jit(jm.apply)({"params": params}, jnp.asarray(x),
                               jnp.asarray(adj))
    pm = GCNIIStack(x.shape[-1], NL, H, alpha=ALPHA, reason_flag=True)
    pm.load_state_dict(gcnii_from_jax(params))
    x_resid, ph = pm(torch.from_numpy(x), torch.from_numpy(adj))
    assert torch.equal(x_resid, torch.from_numpy(x))
    np.testing.assert_allclose(ph.detach().numpy()[valid],
                               np.asarray(jh)[valid], atol=1e-4)


def test_plain_matches_jax_train_kernel_at_rate_0():
    x, adj, umask, jm, params, h, theta = _inputs(seed=1, B=1, N=12)
    got = _plain(adj, h, params, theta, bf16=True)
    want = np.asarray(gcnii_stack_train(
        jnp.asarray(adj), jnp.asarray(h), jnp.asarray(h),
        jnp.asarray(params["conv_w"]), jnp.asarray(theta),
        jnp.asarray(params["reason_w_ih"]), jnp.asarray(params["reason_w_hh"]),
        jnp.asarray(params["reason_b_ih"] + params["reason_b_hh"]),
        alpha=ALPHA, reason=True, rate=0.0, seed=0, interpret=True))
    valid = umask[0] > 0
    # the train kernel is bf16 by construction, and so is the port's bf16
    # mode, rounding at the same points: only f32 summation order differs,
    # and where two orders round a value to adjacent bf16 numbers, the
    # output moves by up to ~1e-5 of its scale (measured 9.8e-6 here; JAX's
    # own jitted run of the kernel is 1.2e-5 from this eager one at N = 40)
    scale = np.abs(got[0][valid]).max()
    assert np.abs(got[0][valid] - want[0][valid]).max() < 2e-5 * scale


def test_no_reason_path_matches_jax_fused_kernel():
    x, adj, umask, jm, params, h, theta = _inputs(seed=2, B=1)
    T = torch.from_numpy
    W = params["conv_w"][:4]
    got = gcnii_stack_fwd(T(adj), T(h), T(h), T(W), T(theta[:4]),
                          alpha=ALPHA, reason=False).numpy()
    want = gcnii_stack_fused(jnp.asarray(adj), jnp.asarray(h),
                             jnp.asarray(h), jnp.asarray(W),
                             jnp.asarray(theta[:4]), alpha=ALPHA,
                             reason=False, interpret=True)
    valid = umask[0] > 0
    np.testing.assert_allclose(got[0][valid], np.asarray(want)[0][valid],
                               atol=1e-5)


def test_packed_weights_are_built_once_and_follow_weight_writes():
    x, adj, umask, jm, params, h, theta = _inputs(seed=3, B=1)
    pm = GCNIIStack(x.shape[-1], NL, H, alpha=ALPHA, reason_flag=True)
    pm.load_state_dict(gcnii_from_jax(params))
    X, A = torch.from_numpy(x), torch.from_numpy(adj)
    valid = umask[0] > 0
    with torch.inference_mode():
        first = pm._packed()
        assert pm._packed() is first            # serving rebuilds nothing
        _, h1 = pm(X, A)
        pm.convs[3].weight.mul_(0.5)            # an in-place weight write
        assert pm._packed() is not first
        _, h2 = pm(X, A)
    with torch.no_grad():
        _, fresh = pm(X, A)
    # the cached path and a fresh build compute the same function exactly
    assert torch.equal(h2, fresh)
    assert not torch.equal(h1[0][valid], h2[0][valid])
    # with autograd on, gradients reach the parameters through the packing
    _, hg = pm(X, A)
    hg.sum().backward()
    assert pm.convs[0].weight.grad is not None
    assert pm.rnn.weight_ih_l0.grad is not None
