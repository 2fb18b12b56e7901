"""The JAX package's production configuration (``--tpu_fast``,
``gcn_backend='pallas'``) in the port: the GCNII stack's bf16 mode (the
plain versions of kernels B and D) against ``gcnii_stack_train`` in
interpret mode, the flagship under ``with_tpu_fast()`` against JAX's, the
three entry points' configurations, and the refusals where JAX runs its
bf16 layer scan instead."""

import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.cli import run_train_erc as j_run_train_erc
from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.graph.adjacency import gcnii_block_adjacency
from mmdfn_tpu.nn.gcn import GCNIIStack as JGCNIIStack
from mmdfn_tpu.ops.pallas_gcnii_train import gcnii_stack_train
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.cli import run_train_erc, sweep
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.models.mm_gcn import MMGCN
from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.ops import gcnii_stack_bwd_plain, gcnii_stack_plain
from mmdfn_torch.ops.gcnii import residual_slabs
from mmdfn_torch.serve import latency_bench
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.trainer import prepare_inputs
from mmdfn_torch.weights import build_model


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


ALPHA, D = 0.2, 24


def _stack_inputs(seed, B, N, nl, H, h0_is_h):
    """The stack's operands as the JAX stack gives them: the block graph
    of B dialogues (the second 4 nodes shorter), h = relu(fc_in(x)) on
    JAX's initial weights, and h0 = h or h scaled per element."""
    rng = np.random.default_rng(seed)
    lengths = np.array([N, N - 4])[:B]
    umask = (np.arange(N)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.standard_normal((B, N, D)) * umask[..., None]).astype(np.float32)
    adj = np.array(fast_jit(gcnii_block_adjacency)(jnp.asarray(x),
                                                   jnp.asarray(umask)))
    jm = JGCNIIStack(nlayers=nl, nhidden=H, alpha=ALPHA, reason_flag=True)
    params = fast_jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                               jnp.asarray(adj))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    h = np.maximum(x @ params["fc_in"]["kernel"] + params["fc_in"]["bias"],
                   0.0).astype(np.float32)
    h0 = h if h0_is_h else (h * rng.uniform(0.5, 1.5, h.shape)).astype(
        np.float32)
    theta = np.log(0.5 / np.arange(1, nl + 1) + 1.0).astype(np.float32)
    lstm = (params["reason_w_ih"], params["reason_w_hh"],
            params["reason_b_ih"] + params["reason_b_hh"])
    dh = rng.standard_normal((B, N, H)).astype(np.float32)
    return adj, h, h0, params["conv_w"], theta, lstm, dh


def _jax_train_kernel(theta):
    return lambda a, he, hz, w, ih, hh, b: gcnii_stack_train(
        a, he, hz, w, jnp.asarray(theta), ih, hh, b, alpha=ALPHA,
        reason=True, rate=0.0, seed=0, interpret=True)


def _scaled_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_plain_bf16_forward_matches_the_jax_train_kernel():
    """16 layers, H = 100, the reason-LSTM, h0 = h (the inputs of
    ``test_torch_gcnii.py``), N = 12 and 40 nodes: the bf16 plain forward
    within 2e-5 of the output's scale of ``gcnii_stack_train``, and the
    f32 path, another function, more than 1e-4 away (measured 1.2e-3 and
    1.8e-3).  Only f32 summation order differs, but where two orders round
    a value to adjacent bf16 numbers the output moves by up to ~1e-5 of
    its scale: the port is 4.2e-8 and 3.8e-6 from JAX's kernel compiled
    here, and JAX's own eager run of it is 9.8e-6 and 1.2e-5 from that
    compile, the largest reading under the bound."""
    for N in (12, 40):
        adj, h, h0, W, theta, lstm, _ = _stack_inputs(1, 1, N, 16, 100,
                                                      True)
        want = np.asarray(fast_jit(_jax_train_kernel(theta))(
            *map(jnp.asarray, (adj, h, h0, W, *lstm))))
        T = torch.from_numpy
        run = lambda bf16: gcnii_stack_plain(
            T(adj), T(h), T(h0), T(W), T(theta), *map(T, lstm), alpha=ALPHA,
            reason=True, mode="bf16" if bf16 else "f32").numpy()
        assert _scaled_err(run(True), want) < 2e-5
        assert _scaled_err(run(False), want) > 1e-4


def test_plain_bf16_backward_matches_the_jax_train_kernel():
    """4 layers, H = 32, B = 2 (masked nodes), h0 apart from h: the bf16
    plain backward on the bf16 plain forward's slabs against ``jax.vjp`` of
    ``gcnii_stack_train``.  d_h_entry and the LSTM gradients within 1e-4
    of each one's scale (measured at most 1.5e-7); d_adj, d_h0 and dW,
    which both round to bf16, every element within one bf16 step of JAX's
    (|diff| <= 2^-7 |JAX| + 1e-6 of the scale; measured equal but for dW,
    1.9e-5 of its scale).  The f32 path fails both bounds (measured
    1.0e-3 to 1.6e-1 of each scale)."""
    adj, h, h0, W, theta, lstm, dh = _stack_inputs(1, 2, 12, 4, 32, False)

    def run(args, dy):
        _, vjp = jax.vjp(_jax_train_kernel(theta), *args)
        return vjp(dy)
    want = [np.asarray(w) for w in fast_jit(run)(
        tuple(map(jnp.asarray, (adj, h, h0, W, *lstm))), jnp.asarray(dh))]
    T = torch.from_numpy
    B, N, H = h.shape

    def grads(bf16):
        mode = "bf16" if bf16 else "f32"
        res = residual_slabs((B, W.shape[0], N, H), mode, "cpu")
        gcnii_stack_plain(T(adj), T(h), T(h0), T(W), T(theta), *map(T, lstm),
                          alpha=ALPHA, reason=True, residuals=res, mode=mode)
        return [g.numpy() for g in gcnii_stack_bwd_plain(
            T(adj), T(h0), T(W), T(theta), *map(T, lstm), res, T(dh),
            alpha=ALPHA, reason=True, mode=mode)]

    def within(got):
        # (d_adj, d_h, d_h0, dW, dW_ih, dW_hh, db): JAX's order is (adj,
        # h_entry, h0, W, ih, hh, b)
        ok = []
        for i, (g, w) in enumerate(zip(got, want)):
            s = np.abs(w).max()
            if i in (0, 2, 3):
                ok.append(bool(np.all(np.abs(g - w)
                                      <= 2.0 ** -7 * np.abs(w) + 1e-6 * s)))
            else:
                ok.append(bool(np.abs(g - w).max() <= 1e-4 * s))
        return ok

    assert all(within(grads(True)))
    assert not any(within(grads(False)))


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=3, min_len=3,
                                  max_len=12, seed=4)
    return path


def test_flagship_under_tpu_fast_matches_jax(pickle_path):
    """The flagship (IEMOCAP GDF + reason, 2 layers, class weights, focal
    loss, Adam) under ``with_tpu_fast()`` at dropout 0, B = 2, L <= 12, on
    the port's seeded weights bridged into the JAX tree, against the JAX
    ``Trainer``'s model (its fused bf16 GCNII kernel and its Pallas bi-GRU,
    both interpreted): log-probs within 1e-4, three steps' losses within
    1e-5 relative."""
    kw = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              Deep_GCN_nlayers=2, dropout=0.0, batch_size=2,
              class_weight=True, buckets=(12,))
    cfg = ExperimentConfig(**kw).with_tpu_fast()
    tr = Trainer(cfg, device="cpu")
    assert tr.model.graph_model.graph_net.mode == "bf16"
    jtr = JTrainer(JConfig(**kw).with_tpu_fast())
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
    batches = list(BucketBatcher(dias, 2, 2, (12,)).epoch(0))[:3]
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        state, jloss, jlogp = jstep(state, j_prepare_inputs(jtr.cfg, b),
                                    jax.random.PRNGKey(i))
        inputs = prepare_inputs(b, tr.device)
        if i == 0:
            with torch.no_grad():
                logp = tr._forward(inputs).numpy()
            valid = b.umask > 0
            np.testing.assert_allclose(logp[valid], np.asarray(jlogp)[valid],
                                       atol=1e-4)
        jlosses.append(float(jloss))
        losses.append(float(tr.train_step(inputs, seed=i)[0]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


# the knobs of TPU_FAST_KNOBS and the two off-values the JAX CLI
# normalises away
KNOBS = tuple(JConfig.TPU_FAST_KNOBS) + ("rnn_compute_dtype",)


@pytest.mark.parametrize("argv", [
    ["--tpu_fast"],
    ["--tpu_fast", "--gcn_backend", "xla", "--rng_impl", "threefry"],
    ["--tpu_fast", "--gcn_compute_dtype", "float32", "--rnn_compute_dtype",
     "float32", "--gcn_bwd_block", "4"],
])
def test_config_from_args_equals_jax(argv):
    """``config_from_args`` of the training CLI sets the knobs as JAX's
    does: ``--tpu_fast`` alone, explicit opt-outs that beat the preset, and
    the off-values normalised to None; ``cli.sweep --tpu_fast`` and
    ``serve/latency_bench.py --tpu_fast`` build ``with_tpu_fast()``."""
    want = j_run_train_erc.config_from_args(
        j_run_train_erc.build_parser().parse_args(argv))
    got = run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(argv))
    assert {k: getattr(got, k) for k in KNOBS} == {
        k: getattr(want, k) for k in KNOBS}
    if argv == ["--tpu_fast"]:
        fast = JConfig().with_tpu_fast()
        base = sweep.base_config(sweep.build_parser().parse_args(
            ["--tpu_fast", "--data_dir", "iem.pkl"]))
        assert {k: getattr(base, k) for k in KNOBS} == {
            k: getattr(fast, k) for k in KNOBS}


def test_latency_bench_serves_the_fast_config(capsys):
    """``serve/latency_bench.py --tpu_fast`` on the CPU (2 layers, one
    short dialogue): its summary says ``tpu_fast`` and the served stack
    runs in the bf16 mode; without the flag ``parity-default``."""
    argv = ["--device", "cpu", "--nlayers", "2", "--n_dialogues", "1",
            "--min_len", "3", "--max_len", "4", "--buckets", "8"]
    for flag, name in ((["--tpu_fast"], "tpu_fast"), ([], "parity-default")):
        assert latency_bench.main(argv + flag) == 0
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert summary["config"] == name
        assert summary["n"] > 0 and summary["device"] == "cpu"


def test_what_jax_sends_to_the_bf16_scan_raises():
    """Where JAX's ``GCNIIStack`` runs its layer scan, ``gcn_compute_
    dtype='bfloat16'`` is JAX's bf16 scan mode, which the port runs as
    kernels B and D's bf16 scan mode: GF2 and DeepGCN under
    ``with_tpu_fast()``, the stack with ``variant=False``, with dropout
    before each layer, after the loop, over 64 layers, or with a
    node-sharded product, and any stack under ``gcn_compute_dtype`` alone.
    Only the encoders' ``rnn_compute_dtype='bfloat16'`` still raises.  The
    flagship's stack takes the bf16 mode, and the families without a GCNII
    stack build; ``gcn_backend='pallas'`` alone on the scan path is JAX's
    f32 scan, which the port runs."""
    fast = dict(backend="pallas", compute_dtype="bfloat16")
    stacks = lambda m: [s for s in m.modules() if isinstance(s, GCNIIStack)]
    scan = [
        *stacks(build_model(ExperimentConfig(graph_type="GF2")
                            .with_tpu_fast())),
        *stacks(build_model(ExperimentConfig(graph_type="DeepGCN",
                                             Deep_GCN_nlayers=2)
                            .with_tpu_fast())),
        MMGCN(200, 2, 100, reason_flag=True, variant=False,
              **fast).graph_net,
        GCNIIStack(24, 2, 32, dropout_mode="before", post_loop_dropout=True,
                   **fast),
        GCNIIStack(24, 2, 32, post_loop_dropout=True, **fast),
        GCNIIStack(24, 65, 32, **fast),
        GCNIIStack(24, 2, 32, spmm=lambda a, h: a @ h, **fast),
        GCNIIStack(24, 2, 32, compute_dtype="bfloat16"),
        *stacks(build_model(ExperimentConfig(
            graph_type="GDF", Deep_GCN_nlayers=2,
            gcn_compute_dtype="bfloat16"))),
    ]
    assert len(scan) == 11
    assert all(s.mode == "bf16_scan" for s in scan)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(ExperimentConfig(graph_type="relation",
                                     rnn_compute_dtype="bfloat16"))
    assert GCNIIStack(24, 64, 32, **fast).mode == "bf16"
    assert GCNIIStack(24, 2, 32, post_loop_dropout=True,
                      backend="pallas").mode == "f32"
    for gt in ("GDF", "GF", "relation", "GCN3", "None"):
        build_model(ExperimentConfig(graph_type=gt, Deep_GCN_nlayers=2)
                    .with_tpu_fast())
