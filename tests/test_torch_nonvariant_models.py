"""The models on the original GCNII update (``variant=False``) against
the JAX package: ``GCNIIStack``, ``MMGCN``, ``MMGCN2`` and ``DeepGCNII``
forward and every parameter's gradient on bridged weights, and the
reference importer's non-variant layers, as the JAX importer takes them.
The stack itself: ``tests/test_torch_nonvariant.py``."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.models.mm_gcn import DeepGCNII as JDeepGCNII
from mmdfn_tpu.models.mm_gcn import MMGCN as JMMGCN
from mmdfn_tpu.models.mm_gcn import MMGCN2 as JMMGCN2
from mmdfn_tpu.nn.gcn import GCNIIStack as JGCNIIStack
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params

from mmdfn_torch.config import GRAPH_H, ExperimentConfig
from mmdfn_torch.models.mm_gcn import MMGCN, MMGCN2, DeepGCNII
from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.tools.import_torch_checkpoint import import_state_dict
from mmdfn_torch.weights import build_model, gcnii_from_jax, params_from_jax

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


# the modules, on bridged weights: (JAX module, port module, JAX params ->
# port state_dict, JAX call args -> port call)
def _stack_case(rng):
    x = rng.standard_normal((B, N, 24)).astype(np.float32)
    adj = (rng.random((B, N, N)) / N).astype(np.float32)
    jm = JGCNIIStack(nlayers=NL, nhidden=H, alpha=ALPHA, reason_flag=True,
                     variant=False)
    pm = GCNIIStack(24, NL, H, alpha=ALPHA, reason_flag=True, variant=False)
    return (jm, pm, lambda p: gcnii_from_jax(p), (x, adj),
            lambda m, x, a, train: m(x, a, train=train)[1],
            lambda p, x, a: jm.apply({"params": p}, x, a)[1])


def _feats(rng, D=24):
    L = N // 3 * 2
    umask = (np.arange(L)[None] < np.array([[L], [L - 3]])).astype(np.float32)
    feats = {m: (rng.standard_normal((B, L, D)) * umask[..., None]).astype(
        np.float32) for m in "avl"}
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, L))]
    return feats, qmask * umask[..., None], umask


def _mmgcn_case(rng):
    feats, qmask, umask = _feats(rng)
    jm = JMMGCN(n_dim=24, nlayers=NL, nhidden=H, nclass=6, dropout=0.0,
                variant=False, reason_flag=True)
    pm = MMGCN(24, NL, H, reason_flag=True, variant=False)
    return (jm, pm, lambda p: gcnii_from_jax(p["graph_net"], "graph_net."),
            (feats, qmask, umask),
            lambda m, f, q, u, train: m(f, q, u, train=train),
            lambda p, f, q, u: jm.apply({"params": p}, f, q, u))


def _mmgcn2_case(rng):
    feats, qmask, umask = _feats(rng)
    jm = JMMGCN2(nfeat=24, nlayers=NL, nhidden=H, nclass=6, dropout=0.0,
                 variant=False)
    pm = MMGCN2(24, NL, H, variant=False)

    def bridge(p):
        sd = {f"fcs.{i}.{k}": T(np.asarray(v).T if k == "weight"
                                else np.asarray(v))
              for i, m in ((0, "a"), (1, "l"), (2, "v"))
              for k, v in (("weight", p[f"fc_{m}"]["kernel"]),
                           ("bias", p[f"fc_{m}"]["bias"]))}
        sd.update({f"convs.{i}.weight": T(np.asarray(w))
                   for i, w in enumerate(p["convs"]["conv_w"])})
        return sd
    return (jm, pm, bridge, (feats, qmask, umask),
            lambda m, f, q, u, train: m(f, q, u, train=train),
            lambda p, f, q, u: jm.apply({"params": p}, f, q, u))


def _deepgcnii_case(rng):
    feats, qmask, umask = _feats(rng)
    x = feats["l"]
    jm = JDeepGCNII(nfeat=24, nlayers=NL, nhidden=H, nclass=6, dropout=0.0,
                    variant=False, reason_flag=True)
    pm = DeepGCNII(24, NL, H, reason_flag=True, n_classes=6, variant=False)

    def bridge(p):
        sd = gcnii_from_jax(p["stack"])
        sd["fcs.1.weight"] = T(np.asarray(p["fc_out"]["kernel"]).T)
        sd["fcs.1.bias"] = T(np.asarray(p["fc_out"]["bias"]))
        return sd
    return (jm, pm, bridge, (x, qmask, umask),
            lambda m, x, q, u, train: m(x, q, u, train=train),
            lambda p, x, q, u: jm.apply({"params": p}, x, q, u))


CASES = {"GCNIIStack": _stack_case, "MMGCN": _mmgcn_case,
         "MMGCN2": _mmgcn2_case, "DeepGCNII": _deepgcnii_case}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nonvariant_module_and_gradients_match_jax(name):
    """Each module with ``variant=False`` (layer weights (H, H)) on JAX's
    init, bridged: the forward within 1e-5 and, in training at dropout 0
    (the stack through the fold and the training Function), every
    parameter's gradient within 1e-4 of its max |.|."""
    rng = np.random.default_rng(len(name))
    jm, pm, bridge, args, port, ref = CASES[name](rng)
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    params = jax.tree_util.tree_map(
        np.asarray, fast_jit(jm.init)(jax.random.PRNGKey(0), *jargs)["params"])
    pm.load_state_dict(bridge(params))
    assert all(c.weight.shape == (H, H) for c in (
        pm.graph_net if name == "MMGCN" else pm).convs)
    out = np.asarray(fast_jit(ref)(params, *jargs))
    R = rng.standard_normal(out.shape).astype(np.float32)
    jgrads = fast_jit(jax.grad(lambda p: jnp.sum(ref(p, *jargs) * R)))(params)
    targs = jax.tree_util.tree_map(T, args)
    with torch.no_grad():
        got = port(pm, *targs, False).numpy()
    np.testing.assert_allclose(got, out, atol=1e-5)
    (port(pm, *targs, True) * T(R)).sum().backward()
    want = bridge(jax.tree_util.tree_map(np.asarray, jgrads))
    got_g = dict(pm.named_parameters())
    assert want.keys() == got_g.keys()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        err = float((got_g[k].grad - w).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


def _model_inputs(B=2, L=4):
    """Zero IEMOCAP inputs: text, qmask, umask, audio, visual."""
    z = lambda D: np.zeros((B, L, D), np.float32)
    return (z(100), z(2), np.ones((B, L), np.float32), z(1582), z(342))


def test_nonvariant_layers_bridge_and_import_as_jax_does():
    """A GDF model whose ``MMGCN`` was built with ``variant=False``: its
    reference-keyed state_dict (the reference's non-variant
    ``GraphConvolution(nhidden, nhidden)`` layers) loads strictly into a
    port template built so, and through the JAX importer into a template
    whose ``conv_w`` is (nl, H, H); the bridge gives it back key for key.
    Into the config's own (variant) model it is refused, as JAX refuses it
    on the config's own tree."""
    kw = dict(graph_type="GDF", reason_flag=True, Deep_GCN_nlayers=NL)
    cfg = ExperimentConfig(**kw)

    def template():
        model = build_model(cfg)
        n_dim = model.graph_model.graph_net.fcs[0].in_features
        model.graph_model = MMGCN(n_dim, NL, GRAPH_H, lamda=cfg.lamda,
                                  alpha=cfg.alpha, reason_flag=True,
                                  variant=False)
        return model
    source = template()
    source.graph_model.reset_parameters(torch.Generator().manual_seed(1))
    sd = {k: v.numpy().copy() for k, v in source.state_dict().items()}
    assert sd["graph_model.graph_net.convs.0.weight"].shape == (GRAPH_H,
                                                                 GRAPH_H)
    model = import_state_dict(sd, cfg, model=template())
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="shape mismatch"):
        import_state_dict(sd, cfg)

    jm = JDialogueGNN.from_config(JConfig(**kw))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *_model_inputs(), deterministic=True))
    jtemplate = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes["params"])
    with pytest.raises(ValueError, match="shape mismatch"):
        state_dict_to_params(sd, jtemplate)
    jtemplate["graph_model"]["graph_net"]["conv_w"] = np.zeros(
        (NL, GRAPH_H, GRAPH_H), np.float32)
    back = params_from_jax(state_dict_to_params(sd, jtemplate))
    assert back.keys() == source.state_dict().keys()
    for k, v in source.state_dict().items():
        assert torch.equal(back[k], v), k
