"""Kernel A (masked bi-GRU layer) and the port's BiRNN / CRN encoder,
held against the JAX package on the same numpy inputs."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.nn.rnn import BiRNN as JBiRNN
from mmdfn_tpu.nn.rnn import _gru_scan
from mmdfn_tpu.nn.rnn import crn_party_delta as j_crn_party_delta
from mmdfn_tpu.ops.pallas_rnn import fused_bigru_layer

from mmdfn_torch.nn.rnn import BiRNN, crn_party_delta
from mmdfn_torch.ops import bigru_layer_fwd, bigru_layer_plain
from mmdfn_torch.weights import gru_from_jax


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


H, B, L = 100, 3, 9


def _layer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.1, 0.1, s).astype(np.float32)
    xg_f = rng.standard_normal((B, L, 3 * H)).astype(np.float32)
    xg_b = rng.standard_normal((B, L, 3 * H)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.35).astype(np.float32)   # holes
    mask[:, 0] = 1.0
    return xg_f, xg_b, u(H, 3 * H), u(3 * H), u(H, 3 * H), u(3 * H), mask


def test_plain_matches_jax_fused_kernel_and_scan():
    xg_f, xg_b, wf, bf, wb, bb, mask = _layer_inputs()
    T = torch.from_numpy
    ys_f, ys_b = bigru_layer_fwd(T(xg_f), T(xg_b), T(wf), T(bf), T(wb), T(bb),
                                 T(mask))
    jf, jb = fast_jit(lambda *a: fused_bigru_layer(*a, interpret=True))(
        *map(jnp.asarray, (xg_f, xg_b, wf, bf, wb, bb, mask)))
    # f32 recurrences of 9 steps; only the summation order differs
    np.testing.assert_allclose(ys_f.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(ys_b.numpy(), np.asarray(jb), atol=1e-5)

    h0 = jnp.zeros((B, H))
    scan = fast_jit(lambda x, w, b, m: _gru_scan(x, w, b, h0, mask=m)[0])
    sf = scan(jnp.asarray(xg_f), jnp.asarray(wf), jnp.asarray(bf),
              jnp.asarray(mask))
    sb = scan(jnp.asarray(xg_b[:, ::-1]), jnp.asarray(wb), jnp.asarray(bb),
              jnp.asarray(mask[:, ::-1]))
    np.testing.assert_allclose(ys_f.numpy(), np.asarray(sf), atol=1e-5)
    np.testing.assert_allclose(ys_b.numpy(), np.asarray(sb)[:, ::-1], atol=1e-5)


def test_masked_frame_is_quarantined():
    """A non-finite input at a masked frame never reaches the carry."""
    xg_f, xg_b, wf, bf, wb, bb, mask = _layer_inputs(1)
    mask[1, 4] = 0.0
    poisoned_f, poisoned_b = xg_f.copy(), xg_b.copy()
    poisoned_f[1, 4] = np.inf
    poisoned_b[1, 4] = np.nan
    T = torch.from_numpy
    clean = bigru_layer_plain(T(xg_f), T(xg_b), T(wf), T(bf), T(wb), T(bb),
                              T(mask))
    dirty = bigru_layer_plain(T(poisoned_f), T(poisoned_b), T(wf), T(bf),
                              T(wb), T(bb), T(mask))
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)


def _jax_birnn(seed=0, B_=2, L_=7, D=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, L_, D)).astype(np.float32)
    jm = JBiRNN(H, num_layers=2, bidirectional=True, cell="gru")
    params = fast_jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                               jnp.ones((B_, L_)))["params"]
    pm = BiRNN(D, H)
    pm.load_state_dict(gru_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return rng, x, jm, params, pm


def test_birnn_matches_jax():
    rng, x, jm, params, pm = _jax_birnn()
    umask = np.ones((2, 7), np.float32)
    umask[1, 5:] = 0.0
    want = fast_jit(jm.apply)({"params": params}, jnp.asarray(x),
                              jnp.asarray(umask))
    got = pm(torch.from_numpy(x), torch.from_numpy(umask))
    valid = umask > 0
    # two stacked f32 recurrences; summation order only
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], atol=1e-5)


def test_crn_party_delta_matches_jax():
    rng, x, jm, params, pm = _jax_birnn(seed=3)
    umask = np.ones((2, 7), np.float32)
    umask[0, 6:] = 0.0
    spk = rng.integers(0, 2, size=(2, 7))
    qmask = np.eye(2, dtype=np.float32)[spk] * umask[..., None]
    rnn = lambda a, m, deterministic=True: jm.apply({"params": params}, a, m)
    want = fast_jit(lambda *a: j_crn_party_delta(rnn, *a))(
        jnp.asarray(x), jnp.asarray(qmask), jnp.asarray(umask))
    got = crn_party_delta(pm, *map(torch.from_numpy, (x, qmask, umask)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_plain_hg_is_each_steps_gate_preactivation():
    """The training mode's hg is h_prev @ W_hh + b_hh of each step, with
    h_prev the walk-order previous output, and asking for it leaves ys
    bit for bit as they were."""
    T = lambda a: torch.from_numpy(a)
    args = [T(a) for a in _layer_inputs(4)]
    ys = bigru_layer_plain(*args)
    ys_f, ys_b, hg_f, hg_b = bigru_layer_plain(*args, with_hg=True)
    assert torch.equal(ys[0], ys_f) and torch.equal(ys[1], ys_b)
    _, _, wf, bf, wb, bb, _ = args
    zero = torch.zeros(B, H)
    for t in range(L):
        prev_f = ys_f[:, t - 1] if t > 0 else zero
        prev_b = ys_b[:, t + 1] if t < L - 1 else zero
        # the same f32 product on the same values
        torch.testing.assert_close(hg_f[:, t], prev_f @ wf + bf, atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(hg_b[:, t], prev_b @ wb + bb, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("batch,rows", [(1, 1), (6, 1), (32, 1), (66, 1),
                                        (67, 2), (192, 4), (528, 4),
                                        (864, 4)])
def test_rows_per_block_fills_the_card_in_one_wave(batch, rows):
    """On an H100's 132 SMs; beyond one wave (B > 264) four rows."""
    from mmdfn_torch.ops.bigru import _rows_per_block
    assert _rows_per_block(batch, 132) == rows
