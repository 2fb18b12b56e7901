"""The encoders' bf16 recurrence in the port (``rnn_compute_dtype=
'bfloat16'``): kernels A and C's plain bf16 scan mode against the JAX
package's bf16 ``_gru_scan`` and ``BiRNN(compute_dtype='bfloat16')``, the
pallas route (kernels A and C's f32 mode on bf16-rounded operands) against
JAX's fused Pallas bi-GRU in interpret mode, the bf16 LSTM, the CRN party
encoder, the config axis, the flagship's log-probs and Trainer steps with
the knob alone and under ``with_tpu_fast()``, and the CLI's config.

JAX is compiled with ``xla_allow_excess_precision`` off: XLA may otherwise
drop a bf16 rounding that the JAX source asks for (a bf16 cast feeding an
f32 cast, or the projection's output read by the f32 Pallas kernel), and
the bits then follow XLA's fusions, not the function."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.cli import run_train_erc as j_run_train_erc
from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.nn.rnn import BiRNN as JBiRNN
from mmdfn_tpu.nn.rnn import _gru_scan
from mmdfn_tpu.nn.rnn import crn_party_delta as j_crn_party_delta
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.cli import run_train_erc
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.nn.rnn import BiRNN, crn_party_delta
from mmdfn_torch.ops import bigru_layer_bwd_plain, bigru_layer_fwd
from mmdfn_torch.ops.bigru import _scan_plain
from mmdfn_torch.train import Trainer
from mmdfn_torch.weights import build_model, build_raw_model, gru_from_jax

# XLA's CPU backend at its lowest optimisation level, every bf16 rounding
# of the source kept
exact_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True,
    xla_allow_excess_precision=False))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L, D, H = 4, 16, 12, 16
BF = torch.bfloat16
# a bf16 step is 2^-8 of an element's magnitude
STEP = 2.0 ** -8
# the input projection's bias gradient: JAX's transpose sums its B L rows
# in bf16 one after another (XLA's bf16 reduce on the CPU), the port in f32
# rounded once (torch's sum); measured up to 5.9 bf16 steps of its scale
# (ten seeds)
BIAS_IH_BOUND = 3e-2
# the input projection's weight gradient sums B L exact products in f32 in
# another order than XLA's: where that rounds to the neighbouring bf16
# value, one step of the element; measured 1 element of 576-768 at most
W_IH_FRACTION = 5e-3
# the 2-layer flagship's log-probs: the encoders take their input from
# f32 projections of the features that the two sides sum in another order
# (~1e-7 apart); where that rounds an input to the neighbouring bf16
# value, a step of 2^-8 of it, the bf16 encoders carry it on: measured
# 2.4e-4 (the knob alone) and 4.0e-4 (with with_tpu_fast())
LOGP_ATOL = 1e-3
# the 2-layer flagship's losses after Adam steps: Adam's first step moves a
# weight by the learning rate whatever its gradient's size, so where an
# input projection bias's gradient is near 0 and the two sums above round
# it to another sign, that weight moves 2 lr apart; measured 7.4e-5
# relative at the third step (the first 1e-6)
LOSS_RTOL = 3e-4


def _mask():
    m = np.ones((B, L), np.float32)
    m[1, 11:] = 0.0
    m[2, 3] = 0.0          # a hole, as the party streams have
    m[3, 8:] = 0.0
    return m


def _scaled(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ulps(got, want):
    """|got - want| in bf16 steps at want's magnitude (8 significant
    bits)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) / ulp


def _equal_but_projection(pairs):
    """Every pair equal bit for bit but the input projection's weight
    (``W_IH_FRACTION``, one bf16 step) and bias (``BIAS_IH_BOUND``)
    gradients."""
    for name, (got, want) in pairs.items():
        if name.startswith("bias_ih"):
            assert _scaled(got, want) <= BIAS_IH_BOUND, name
        elif name.startswith("weight_ih"):
            off = got != want
            assert off.mean() <= W_IH_FRACTION, name
            assert np.all(_ulps(got, want)[off] <= 1.0), name
        else:
            assert np.array_equal(got, want), name


def _birnn_against_jax(cell, backend, seed=0):
    """JAX's and the port's 2-layer BiRNN(compute_dtype='bfloat16') on the
    same weights: (port, JAX) pairs of the output and of the gradients of
    x and every parameter (the port's names), for a seeded cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    dy = rng.standard_normal((B, L, 2 * H)).astype(np.float32)
    mask = _mask()
    jm = JBiRNN(H, num_layers=2, bidirectional=True, cell=cell,
                compute_dtype="bfloat16", backend=backend)
    params = exact_jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                                jnp.ones((B, L)))["params"]

    @exact_jit
    def g(p, x, dy):
        y, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x,
                                               jnp.asarray(mask)), p, x)
        return y, vjp(dy)
    jy, (jdp, jdx) = g(params, jnp.asarray(x), jnp.asarray(dy))
    pm = BiRNN(D, H, cell=cell, compute_dtype="bfloat16", backend=backend)
    pm.load_state_dict(gru_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params)))
    X = torch.tensor(x, requires_grad=True)
    y = pm(X, torch.tensor(mask))
    grads = torch.autograd.grad(y, [X, *pm.parameters()], torch.tensor(dy))
    want = gru_from_jax(jax.tree_util.tree_map(np.asarray, jdp))
    pairs = {"y": (y.detach(), jy), "dx": (grads[0], jdx)}
    for (name, _), got in zip(pm.named_parameters(), grads[1:]):
        pairs[name] = (got, want[name])
    return pm, {k: (np.asarray(a, np.float32), np.asarray(b, np.float32))
                for k, (a, b) in pairs.items()}


def _layer_inputs(seed=1):
    """One layer's bf16 operands: xg (B, L, 3H) per direction, W_hh (H,
    3H), b_hh, the mask, and the cotangents of ys."""
    rng = np.random.default_rng(seed)
    bf = lambda *s, k=1.0: torch.tensor(
        (rng.standard_normal(s) * k).astype(np.float32)).to(BF)
    ops = (bf(B, L, 3 * H), bf(B, L, 3 * H), bf(H, 3 * H, k=0.3),
           bf(3 * H, k=0.3), bf(H, 3 * H, k=0.3), bf(3 * H, k=0.3))
    return ops, torch.tensor(_mask()), (bf(B, L, H), bf(B, L, H))


def test_plain_scan_equals_jax_bit_for_bit():
    """One layer: the plain bf16 scan (kernels A and C's scan mode) equals
    JAX's bf16 ``_gru_scan`` per direction bit for bit in ys, dxg, dW_hh
    and db_hh (JAX sums dW_hh and db_hh step by step, in bf16, from the
    last step down), and autograd through the plain forward gives the
    plain backward's bits.  The 2-layer ``BiRNN(compute_dtype=
    'bfloat16')`` equals JAX's in its output and every gradient but the
    input projection's (``_equal_but_projection``)."""
    ops, mask, dys = _layer_inputs()
    J = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jmask = jnp.asarray(mask.numpy())

    def f(xf, xb, wf, bf, wb, bb):
        h0 = jnp.zeros((B, H), jnp.bfloat16)
        yf, _ = _gru_scan(xf, wf, bf, h0, mask=jmask)
        yb, _ = _gru_scan(xb[:, ::-1], wb, bb, h0, mask=jmask[:, ::-1])
        return yf, yb[:, ::-1]

    @exact_jit
    def g(args, dys):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(dys)
    jys, jgrads = g(tuple(map(J, ops)), tuple(map(J, dys)))
    leaves = [t.clone().requires_grad_(True) for t in ops]
    ys = _scan_plain(*leaves, mask)
    auto = torch.autograd.grad(ys, leaves, dys)
    # the explicit walk, in the kernel's argument order
    walk = bigru_layer_bwd_plain(*ops, mask, *(y.detach() for y in ys), *dys,
                                 mode="bf16_scan")
    for got, want in zip(ys, jys):
        assert np.array_equal(got.detach().float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
    order = (0, 1, 2, 3, 4, 5)      # dxg_f, dxg_b, dW_f, db_f, dW_b, db_b
    for i, want in zip(order, jgrads):
        got = walk[(0, 1, 2, 3, 4, 5)[i]]
        assert torch.equal(got, auto[i])
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
    _, pairs = _birnn_against_jax("gru", None)
    _equal_but_projection(pairs)


def test_pallas_route_matches_jax_interpreted():
    """``BiRNN(backend='pallas', compute_dtype='bfloat16')``: kernels A and
    C's f32 mode on bf16-rounded operands, ys rounded to bf16, against
    JAX's fused Pallas bi-GRU (interpreted on the CPU) on the same bf16
    operands.  The f32 recurrences sum in another order, and where that
    rounds a layer-0 output to the neighbouring bf16 value, layer 1 and
    every gradient move with it: the bound is two bf16 steps of each
    tensor's scale (the input projection's bias gradient:
    ``BIAS_IH_BOUND``); measured over ten seeds 1.27 steps (dx), with up
    to 0.5% of the outputs and 6% of a weight gradient's elements
    differing."""
    pm, pairs = _birnn_against_jax("gru", "pallas", seed=2)
    assert pm.mode == "bf16"
    for name, (got, want) in pairs.items():
        bound = BIAS_IH_BOUND if name.startswith("bias_ih") else 2 * STEP
        assert _scaled(got, want) <= bound, name


def test_lstm_cell_in_bf16_matches_jax():
    """``BiRNN(cell='lstm', compute_dtype='bfloat16')``: the bf16 step loop
    (JAX's bf16 ``_lstm_scan``, no kernel in either package) equals JAX's
    output and gradients bit for bit, the input projection's aside
    (``_equal_but_projection``)."""
    pm, pairs = _birnn_against_jax("lstm", None, seed=3)
    assert pm.mode == "bf16_scan"
    _equal_but_projection(pairs)


def test_crn_party_delta_in_bf16_matches_jax():
    """The CRN party encoder (``rnn_parties``: B x P streams with holed
    masks) with a bf16 scan encoder, against JAX's, bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, L, D)).astype(np.float32)
    umask = np.ones((2, L), np.float32)
    umask[0, 12:] = 0.0
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, L))] \
        * umask[..., None]
    jm = JBiRNN(H, num_layers=2, bidirectional=True, cell="gru",
                compute_dtype="bfloat16")
    params = exact_jit(jm.init)(jax.random.PRNGKey(5), jnp.asarray(x),
                                jnp.ones((2, L)))["params"]
    rnn = lambda a, m, deterministic=True: jm.apply({"params": params}, a, m)
    want = exact_jit(lambda *a: j_crn_party_delta(rnn, *a))(
        jnp.asarray(x), jnp.asarray(qmask), jnp.asarray(umask))
    pm = BiRNN(D, H, compute_dtype="bfloat16")
    pm.load_state_dict(gru_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params)))
    got = crn_party_delta(pm, *map(torch.from_numpy, (x, qmask, umask)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.detach().numpy(), np.asarray(want))


def test_config_axis_equals_solo_runs():
    """The scan mode under ``torch.func.vmap`` (the grouped sweep's config
    axis: one call over K = 3 stacked weights, the mask shared) equals
    each configuration's run alone bit for bit, forward and gradients."""
    ops, mask, dys = _layer_inputs(seed=7)
    K = 3
    stacked = [torch.stack([t * (1 + k / 8) for k in range(K)]).to(BF)
               for t in ops]
    leaves = [t.clone().requires_grad_(True) for t in stacked]
    ys = torch.func.vmap(
        lambda *a: bigru_layer_fwd(*a, mask, mode="bf16_scan"))(*leaves)
    dK = [torch.stack([d] * K) for d in dys]
    grads = torch.autograd.grad(ys, leaves, dK)
    for k in range(K):
        solo = [t[k].detach().clone().requires_grad_(True) for t in stacked]
        ys_k = bigru_layer_fwd(*solo, mask, mode="bf16_scan")
        g_k = torch.autograd.grad(ys_k, solo, dys)
        assert all(torch.equal(a[k], b) for a, b in zip(ys, ys_k))
        assert all(torch.equal(a[k], b) for a, b in zip(grads, g_k))


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    # dialogues of at most 8 turns: JAX unrolls its scans 8 steps at a
    # time, and a ninth step makes XLA compile twice the steps
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=3, min_len=3,
                                  max_len=8, seed=4)
    return path


@pytest.mark.parametrize("fast", [False, True], ids=["alone", "tpu_fast"])
def test_flagship_with_bf16_encoders_matches_jax(pickle_path, fast):
    """The flagship (IEMOCAP GDF + reason, 2 layers, class weights, focal
    loss, Adam) with ``rnn_compute_dtype='bfloat16'``, alone (the encoders
    in the bf16 scan mode) and under ``with_tpu_fast()`` (their bf16 mode;
    the stack in kernels B and D's bf16 mode) at dropout 0, B = 2, L <= 8,
    on the port's weights bridged into the JAX tree, against the JAX
    ``Trainer``'s model: log-probs within ``LOGP_ATOL``, three steps'
    losses within ``LOSS_RTOL``."""
    kw = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              Deep_GCN_nlayers=2, dropout=0.0, batch_size=2,
              class_weight=True, buckets=(8,), rnn_compute_dtype="bfloat16")
    cfg, jcfg = ExperimentConfig(**kw), JConfig(**kw)
    if fast:
        cfg, jcfg = cfg.with_tpu_fast(), jcfg.with_tpu_fast()
    tr = Trainer(cfg, device="cpu")
    assert {r.mode for r in tr.model.modules() if isinstance(r, BiRNN)} \
        == {"bf16" if fast else "bf16_scan"}
    jtr = JTrainer(jcfg)
    shapes = jax.eval_shape(lambda: jtr._init_variables(
        jax.random.PRNGKey(0), jtr._example_inputs()))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = state_dict_to_params(
        {k: v.numpy() for k, v in tr.model.state_dict().items()}, template)
    state = (params, exact_jit(jtr.tx.init)(params))

    @exact_jit
    def jstep(state, inputs, key):
        p, opt = state
        logp = jtr._apply_model(p, inputs, True, None)
        loss, grads = jax.value_and_grad(lambda q: jtr._loss(
            jtr._apply_model(q, inputs, False, {"dropout": key}),
            inputs["label"], inputs["umask"]))(p)
        updates, opt = jtr.tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss, logp

    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    batches = list(BucketBatcher(dias, 2, 2, (8,)).epoch(0))[:3]
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
                                       atol=LOGP_ATOL)
        jlosses.append(float(jloss))
        losses.append(float(tr.train_step(inputs, seed=i)[0]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)


def test_cli_config_and_models_take_the_knob():
    """``--rnn_compute_dtype bfloat16``, alone and with ``--tpu_fast``: the
    parsed config's knobs equal JAX's ``config_from_args`` for the same
    argv, and every multimodal family and the raw-input model build with
    every encoder in the mode the knob selects (the DailyDialogue model
    and the non-graph baselines take none, as in JAX)."""
    knobs = tuple(JConfig.TPU_FAST_KNOBS) + ("rnn_compute_dtype",)
    encoders = lambda m: {r.mode for r in m.modules()
                          if isinstance(r, BiRNN)}
    for extra, mode in (([], "bf16_scan"), (["--tpu_fast"], "bf16")):
        argv = ["--rnn_compute_dtype", "bfloat16", *extra]
        want = j_run_train_erc.config_from_args(
            j_run_train_erc.build_parser().parse_args(argv))
        got = run_train_erc.config_from_args(
            run_train_erc.build_parser().parse_args(argv))
        assert {k: getattr(got, k) for k in knobs} == {
            k: getattr(want, k) for k in knobs}
        for gt in ("GDF", "GF", "GF2", "DeepGCN", "relation", "GCN3",
                   "None"):
            cfg = ExperimentConfig(graph_type=gt, Deep_GCN_nlayers=2,
                                   reason_flag=gt == "GDF", **{
                                       k: getattr(got, k) for k in knobs})
            assert encoders(build_model(cfg)) == {mode}, gt
        assert encoders(build_raw_model(cfg)) == {mode}
    for other in (dict(graph_model=False, base_model="GRU"),
                  dict(dataset="DailyDialogue", base_model="GRU")):
        cfg = ExperimentConfig(rnn_compute_dtype="bfloat16", **other)
        assert encoders(build_model(cfg)) <= {"f32"}
