"""The port's dropout rate per configuration (``mmdfn_torch/nn/
drop_override.py``) against ``mmdfn_tpu/nn/drop_override.py``: the
thresholds, keep and keep scale bit for bit, the refusals, the scoping;
the plain GCNII stack with a rate per configuration under ``vmap`` against
static-rate calls; and a tagged site under the override against the model
rebuilt at that rate (``tests/test_drop_override.py``'s claims)."""

import numpy as np
import pytest
import torch
from torch.func import vmap

from mmdfn_tpu.nn import drop_override as j_drop

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.nn import drop_override
from mmdfn_torch.ops import gcnii_stack_bwd_plain, gcnii_stack_plain, philox
from mmdfn_torch.ops.gcnii import RESIDUALS
from mmdfn_torch.weights import build_model

RATES = (0.0, 0.1, 0.2, 0.25, 0.4, 0.5, 0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rate", RATES)
def test_make_drop_rate_matches_jax_bit_for_bit(rate):
    """thresh, keep and inv_keep equal JAX's bits, alone and stacked; the
    threshold is the static path's (``philox.threshold``); keep is the f32
    a static site's Python-float keep rounds to."""
    got, want = drop_override.make_drop_rate(rate), j_drop.make_drop_rate(
        rate)
    for name in ("rate", "keep", "thresh", "inv_keep"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape == (), name
        assert a.tobytes() == b.tobytes(), name
    assert int(got.thresh.numpy().view(np.uint32)) == philox.threshold(rate)
    assert float(got.keep) == float(np.float32(1.0 - rate))
    stacked = drop_override.make_drop_rate([rate, 0.4])
    want = j_drop.make_drop_rate([rate, 0.4])
    for name in ("keep", "thresh", "inv_keep"):
        assert getattr(stacked, name).numpy().tobytes() == np.asarray(
            getattr(want, name)).tobytes(), name


@pytest.mark.parametrize("rates", [-0.1, 1.0, [0.2, 1.0], [0.0, -1e-9]])
def test_make_drop_rate_refuses_as_jax(rates):
    """Rates outside [0, 1) are refused with JAX's message."""
    msgs = []
    for fn in (drop_override.make_drop_rate, j_drop.make_drop_rate):
        with pytest.raises(ValueError) as e:
            fn(rates)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "[0, 1)" in msgs[0]


def test_override_is_scoped_and_nests_as_jax():
    """Outside the context nothing is installed; an inner override of a
    tag wins and leaves the outer one on exit; untagged sites never see
    one; ``resolve`` gives a site's static floats without one."""
    for mod in (drop_override, j_drop):
        a, b = mod.make_drop_rate(0.3), mod.make_drop_rate(0.1)
        assert mod.get("dropout") is None
        with mod.override({"dropout": a}):
            assert mod.get("dropout") is a and mod.get("other") is None
            assert mod.get(None) is None
            with mod.override({"dropout": b, "other": a}):
                assert mod.get("dropout") is b and mod.get("other") is a
            assert mod.get("dropout") is a and mod.get("other") is None
            keep, inv, ov = mod.resolve("dropout", 0.5)
            assert ov is a and keep is a.keep and inv is a.inv_keep
        assert mod.get("dropout") is None
    for rate in RATES:
        assert drop_override.resolve("dropout", rate) == j_drop.resolve(
            "dropout", rate)


def _stack_operands(K=3, B=2, N=9, H=100, nl=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3
    adj = torch.rand(K, B, N, N, generator=g) / N
    h0 = torch.relu(r(K, B, N, H))
    return dict(adj=adj, h=h0 * 1.25, h0=h0, W=r(K, nl, 2 * H, H),
                ih=r(K, H, 4 * H), hh=r(K, H, 4 * H), b=r(K, 4 * H),
                theta=torch.log(0.5 / torch.arange(1, nl + 1) + 1.0))


def test_plain_stack_with_a_rate_per_config_equals_static_calls():
    """The plain GCNII stack forward and backward, ``vmap``ped over K = 3
    configurations at rates {0, 0.2, 0.4} (one DropRate), equal K calls at
    each static rate on the same seed, bit for bit: the rate-0
    configuration keeps every element, as its static call, which draws
    nothing."""
    o = _stack_operands()
    K, B, nl, N, H = 3, 2, 3, 9, 100
    rates = [0.0, 0.2, 0.4]
    seed = torch.tensor([2021], dtype=torch.int64)
    opts = dict(alpha=0.2, reason=True)
    per = (o["adj"], o["h"], o["h0"], o["W"], o["ih"], o["hh"], o["b"])

    def fwd(adj, h, h0, W, ih, hh, b, res, rate):
        return gcnii_stack_plain(adj, h, h0, W, o["theta"], ih, hh, b,
                                 rate=rate, seed=seed, residuals=res, **opts)

    res = [torch.zeros(K, B, nl, N, H) for _ in RESIDUALS]
    out = vmap(fwd)(*per, res, drop_override.make_drop_rate(rates))
    dh = torch.randn(K, B, N, H, generator=torch.Generator().manual_seed(1))

    def bwd(adj, h0, W, ih, hh, b, res, dh, rate):
        return gcnii_stack_bwd_plain(adj, h0, W, o["theta"], ih, hh, b, res,
                                     dh, rate=rate, seed=seed, **opts)

    grads = vmap(bwd)(o["adj"], o["h0"], o["W"], o["ih"], o["hh"], o["b"],
                      res, dh, drop_override.make_drop_rate(rates))
    for k, rate in enumerate(rates):
        res_k = [torch.zeros(B, nl, N, H) for _ in RESIDUALS]
        s = None if rate == 0.0 else seed
        want = gcnii_stack_plain(*(t[k] for t in per[:4]), o["theta"],
                                 *(t[k] for t in per[4:]), rate=rate,
                                 seed=s, residuals=res_k, **opts)
        assert torch.equal(out[k], want), k
        for a, b in zip(res, res_k):
            assert torch.equal(a[k], b), k
        want_g = gcnii_stack_bwd_plain(
            o["adj"][k], o["h0"][k], o["W"][k], o["theta"], o["ih"][k],
            o["hh"][k], o["b"][k], res_k, dh[k], rate=rate, seed=s, **opts)
        for a, b in zip(grads, want_g):
            assert torch.equal(a[k], b), k
    # the rates bite: configuration 1 at 0.2 is not configuration 2 at 0.4
    assert not torch.equal(out[1], out[2])


def _inputs(cfg, B=2, L=6, seed=0):
    rng = np.random.default_rng(seed)
    info = cfg.info
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    spk = torch.from_numpy(rng.integers(0, info["n_speakers"], (B, L)))
    return (f(B, L, cfg.D_m), torch.nn.functional.one_hot(
        spk, info["n_speakers"]).float(), torch.ones(B, L),
        f(B, L, info["D_audio"]), f(B, L, info["D_visual"]))


def _forward(cfg, inputs, init, rate=None, grads=False):
    model = build_model(cfg, init)
    gen = torch.Generator().manual_seed(42)
    ctx = (drop_override.override({"dropout": drop_override.make_drop_rate(
        rate)}) if rate is not None else torch.enable_grad())
    with ctx:
        out = model(*inputs, train=True, generator=gen)
    if not grads:
        return out
    loss = (out * torch.sin(torch.arange(out.numel(), dtype=torch.float32)
                            .reshape(out.shape))).sum()
    names = [n for n, _ in model.named_parameters()]
    return out, dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()), allow_unused=True)))


@pytest.mark.parametrize("graph_type,extra", [
    ("GDF", dict(reason_flag=True)), ("relation", {}), ("GF2", {}),
    ("DeepGCN", dict(reason_flag=True))])
def test_override_forward_equals_static_rebuild(graph_type, extra):
    """A dropout-0.4 model under override(0.2) equals the model rebuilt at
    0.2, bit for bit, on the same generator (every site built from
    cfg.dropout reads the override, and no other does); and differs from
    the 0.4 forward without it."""
    kw = dict(Deep_GCN_nlayers=2, graph_type=graph_type, **extra)
    base = ExperimentConfig(dropout=0.4, **kw)
    init = build_model(base).state_dict()
    inputs = _inputs(base)
    over = _forward(base, inputs, init, rate=0.2)
    static = _forward(ExperimentConfig(dropout=0.2, **kw), inputs, init)
    assert torch.equal(over, static), graph_type
    assert not torch.equal(over, _forward(base, inputs, init)), graph_type


def test_override_gradients_and_rate_zero_equal_static_rebuild():
    """Backward too: the gradients through override(0.2) equal the
    dropout-0.2 rebuild's bit for bit; and override(0) equals the rate-0
    model (every draw keeps, scaled by exactly 1)."""
    kw = dict(Deep_GCN_nlayers=2, graph_type="GDF", reason_flag=True)
    base = ExperimentConfig(dropout=0.4, **kw)
    init = build_model(base).state_dict()
    inputs = _inputs(base, seed=5)
    out, g_over = _forward(base, inputs, init, rate=0.2, grads=True)
    want, g_stat = _forward(ExperimentConfig(dropout=0.2, **kw), inputs,
                            init, grads=True)
    assert torch.equal(out, want)
    for name, a in g_over.items():
        b = g_stat[name]
        assert (a is None and b is None) or torch.equal(a, b), name
    zero = _forward(base, inputs, init, rate=0.0)
    assert torch.equal(zero, _forward(ExperimentConfig(dropout=0.0, **kw),
                                      inputs, init))
