"""``MultiHeadAttention`` (reference ``model.py:88-165``) in the port
against the JAX package's, for each score function, one and two heads,
and either softmax axis."""

from functools import partial

import numpy as np
import pytest
import torch

import jax

from mmdfn_tpu.nn.attention import MultiHeadAttention as JMultiHeadAttention

from mmdfn_torch.nn.attention import MultiHeadAttention

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


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("score_function,n_head,faithful", [
    ("dot_product", 1, True), ("dot_product", 2, False),
    ("scaled_dot_product", 1, False), ("scaled_dot_product", 2, True),
    ("mlp", 1, True), ("mlp", 2, False), ("bi_linear", 1, False),
    ("bi_linear", 2, True)])
def test_multihead_attention_matches_jax(score_function, n_head, faithful):
    """``tests/test_attention_oracle.py``'s shapes: the output and the
    scores on JAX's weights, with the scores softmaxed over the keys or,
    as the reference does, over the fused head-batch axis; and one step's
    query (a 2-d q)."""
    rng = np.random.default_rng(0)
    E, B, Lk, Lq = 8, 3, 5, 4
    k = rng.standard_normal((B, Lk, E)).astype(np.float32)
    q = rng.standard_normal((B, Lq, E)).astype(np.float32)
    jm = JMultiHeadAttention(embed_dim=E, n_head=n_head,
                             score_function=score_function,
                             faithful_softmax_dim0=faithful)
    p = jax.tree_util.tree_map(np.asarray, fast_jit(jm.init)(
        jax.random.PRNGKey(0), k, q)["params"])
    pm = MultiHeadAttention(E, n_head=n_head, score_function=score_function,
                            faithful_softmax_dim0=faithful)
    sd = {f"{n}.{w}": T(np.array(p[n][j].T if w == "weight" else p[n][j]))
          for n in ("w_k", "w_q", "proj")
          for w, j in (("weight", "kernel"), ("bias", "bias"))}
    if "weight" in p:
        sd["weight"] = T(p["weight"])
    pm.load_state_dict(sd)
    apply = fast_jit(partial(jm.apply, deterministic=True))
    for qq in (q, q[:, 0]):
        out, score = apply({"params": p}, k, qq)
        with torch.no_grad():
            got, got_score = pm(T(k), T(qq))
        np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5)
        np.testing.assert_allclose(got_score.numpy(), np.asarray(score),
                                   atol=1e-5)
