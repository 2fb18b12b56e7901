"""The port's CUDA kernels against their plain versions on the card.

These tests import no JAX, so the card's machine can run them:
``python -m pytest --noconftest -q tests/test_torch_gpu.py``.  Without a
card each test skips itself.
"""

import pytest
import torch

from mmdfn_torch.graph.adjacency import mm_big_adjacency
from mmdfn_torch.ops import (bigru_layer_bwd, bigru_layer_bwd_plain,
                             bigru_layer_fwd, bigru_layer_plain,
                             gcnii_stack_bwd, gcnii_stack_bwd_plain,
                             gcnii_stack_fwd, gcnii_stack_plain, philox,
                             plain_ops)
from mmdfn_torch.ops.bigru import _forward as bigru_forward
from mmdfn_torch.ops.gcnii import RESIDUALS

H = 100


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bigru_args(dev, B, L, seed):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    xg_f = torch.randn(B, L, 3 * H, generator=g).to(dev)
    xg_b = torch.randn(B, L, 3 * H, generator=g).to(dev)
    mask = (torch.rand(B, L, generator=g) > 0.3).float().to(dev)  # holes
    w_f, w_b = u(3 * H, H), u(3 * H, H)
    return (xg_f, xg_b, w_f.t(), u(3 * H), w_b.t(), u(3 * H), mask), g


# every rows-per-block variant of kernels A and C on an H100 (B = 1..66:
# 1 row, 67: 2, 133 and 192: 4, 300: 4 in more than one wave), ragged
# tails, L = 1, and the training shapes
BIGRU_SHAPES = [(1, 200), (6, 64), (13, 9), (32, 80), (67, 1), (133, 7),
                (192, 80), (300, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", BIGRU_SHAPES)
def test_bigru_kernel_matches_plain(B, L):
    dev = _card()
    args, _ = _bigru_args(dev, B, L, B * 1000 + L)
    got = bigru_layer_fwd(*args)
    torch.cuda.synchronize()
    want = bigru_layer_plain(*args)
    for a, b in zip(got, want):
        # f32 on both sides; only the summation order of h @ W_hh differs
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", BIGRU_SHAPES)
def test_bigru_bwd_kernel_matches_plain(B, L):
    """Kernel C on the ys and hg that kernel A's training mode wrote, at
    the training shapes (lstm_l B = 32, the party streams B = 192, both
    L = 80, holed masks) and the other variants."""
    dev = _card()
    args, g = _bigru_args(dev, B, L, B * 7 + L)
    ys_hg = bigru_forward(*args, with_hg=True)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    got = bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])
    torch.cuda.synchronize()
    want = bigru_layer_bwd_plain(*args, *ys_hg[:2], *dy)
    for a, b in zip(got, want):
        # f32; dW_hh sums B L terms in another order: relative to its scale
        scale = float(b.abs().max().clamp(min=1.0))
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", [(6, 64), (192, 80)])
def test_bigru_training_mode_writes_the_plain_hg(B, L):
    """Kernel A's training mode: ys bit-equal to the serve launch, hg equal
    to the plain forward's."""
    dev = _card()
    args, _ = _bigru_args(dev, B, L, B + 5 * L)
    serve = bigru_forward(*args)
    got = bigru_forward(*args, with_hg=True)
    torch.cuda.synchronize()
    assert torch.equal(serve[0], got[0]) and torch.equal(serve[1], got[1])
    want = bigru_layer_plain(*args, with_hg=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_bigru_kernels_keep_masked_frames_out():
    """An all-masked row and a NaN in a masked frame: every output and
    gradient finite, and the clean rows as without the poison."""
    dev = _card()
    B, L = 13, 20
    args, g = _bigru_args(dev, B, L, 99)
    xg_f, xg_b, w_f, b_f, w_b, b_b, mask = args
    mask = mask.clone()
    mask[3] = 0.0                        # a row with no valid frame
    mask[5, 7] = 0.0
    xg_f, xg_b = xg_f.clone(), xg_b.clone()
    xg_f[5, 7] = float("nan")
    xg_b[5, 7] = float("inf")
    xg_f[3] = float("nan")
    args = (xg_f, xg_b, w_f, b_f, w_b, b_b, mask)
    ys_hg = bigru_forward(*args, with_hg=True)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    grads = bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])
    torch.cuda.synchronize()
    for t in (*ys_hg, *grads):
        assert bool(torch.isfinite(t).all())
    assert not bool(ys_hg[0][3].any()) and not bool(ys_hg[1][3].any())
    assert not bool(grads[0][3].any()) and not bool(grads[0][5, 7].any())


@pytest.mark.gpu
def test_bigru_kernels_refuse_a_width_they_do_not_take():
    """The kernels hold W_hh in registers for H = 100 only: another width
    raises before any launch."""
    dev = _card()
    B, L, width = 2, 3, 64
    xg = torch.zeros(B, L, 3 * width, device=dev)
    w = torch.zeros(width, 3 * width, device=dev)
    b = torch.zeros(3 * width, device=dev)
    mask = torch.ones(B, L, device=dev)
    before = bigru_layer_fwd.launches
    with pytest.raises(ValueError, match="H = 100"):
        bigru_layer_fwd(xg, xg, w, b, w, b, mask)
    assert bigru_layer_fwd.launches == before


@pytest.mark.gpu
def test_bigru_bwd_weight_gradients_are_deterministic():
    """Kernel C sums dW_hh and db_hh in a fixed order: two launches give
    the same bits."""
    dev = _card()
    B, L = 192, 80
    args, g = _bigru_args(dev, B, L, 17)
    ys_hg = bigru_forward(*args, with_hg=True)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    first = [t.clone() for t in
             bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])]
    second = bigru_layer_bwd(*args, *ys_hg[:2], *dy, *ys_hg[2:])
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _gcnii_args(dev, B, L, nl, reason, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(max(1, L // 4), L + 1, (B,), generator=g)
    lengths[0] = L
    umask = (torch.arange(L)[None] < lengths[:, None]).float()
    feats = [torch.randn(B, L, 200, generator=g) * umask[..., None]
             for _ in range(3)]
    adj = mm_big_adjacency(feats, umask).to(dev)
    N = 3 * L
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    h = torch.relu(torch.randn(B, N, H, generator=g)).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    lstm = (u(4 * H, H).t(), u(4 * H, H).t(), u(4 * H)) if reason \
        else (None, None, None)
    return (adj, h, h, u(nl, 2 * H, H), theta, *lstm), g


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B,L", [(1, 200), (2, 13)])
def test_gcnii_kernel_matches_plain(B, L, reason):
    dev = _card()
    args, _ = _gcnii_args(dev, B, L, 16, reason, B * 1000 + L)
    if not reason:
        args = args[:5]
    got = gcnii_stack_fwd(*args, alpha=0.2, reason=reason)
    torch.cuda.synchronize()
    want = gcnii_stack_plain(*args, alpha=0.2, reason=reason)
    # f32 on both sides over 16 layers; only the summation order differs.
    # The reason skip grows h to O(10), so the bound scales with it.
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)


def _train_fwd(args, reason, rate, seed, plain):
    adj, h = args[0], args[1]
    B, N, _ = h.shape
    nl = args[3].shape[0]
    res = [torch.empty(B, nl, N, H, device=h.device) for _ in RESIDUALS]
    for r in res[1:3]:
        r.zero_()
    fwd = gcnii_stack_plain if plain else gcnii_stack_fwd
    out = fwd(*args, alpha=0.2, reason=reason, rate=rate, seed=seed,
              residuals=res)
    return out, res


@pytest.mark.gpu
@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("B,L", [(32, 80), (1, 9)])
def test_gcnii_train_kernels_match_plain(B, L, reason):
    """Kernel B's training mode (dropout 0.4, residuals) and kernel D at the
    training shapes (B = 32, N = 240, 16 layers) and a ragged one (N = 27),
    both against their plain versions on identical residuals."""
    dev = _card()
    args, g = _gcnii_args(dev, B, L, 16, reason, 31 * B + L)
    seed = torch.tensor([0x5DEECE66D1234], dtype=torch.int64, device=dev)
    out, res = _train_fwd(args, reason, 0.4, seed, plain=False)
    torch.cuda.synchronize()
    want, want_res = _train_fwd(args, reason, 0.4, seed, plain=True)
    scale = float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(out, want, atol=1e-5 * scale, rtol=0)
    for a, b in zip(res, want_res):
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)

    adj, _, h0, W, theta, ih, hh, lb = args
    dh = torch.randn(out.shape, generator=g).to(dev)
    got = gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh,
                          alpha=0.2, reason=reason, rate=0.4, seed=seed)
    torch.cuda.synchronize()
    ref = gcnii_stack_bwd_plain(adj, h0, W, theta, ih, hh, lb, res, dh,
                                alpha=0.2, reason=reason, rate=0.4, seed=seed)
    for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh",
                           "db"), got, ref):
        # f32; sums over up to B N rows and 16 layers in another order
        s = float(b.abs().max().clamp(min=1e-6))
        assert float((a - b).abs().max()) <= 1e-4 * s, name


@pytest.mark.gpu
def test_gcnii_dropout_mask_is_the_plain_philox_mask():
    """With W = 0, alpha = 1 and no reason, layer l's output is
    keep_l * (1 - theta_l) h0 / (1 - rate), so the residual of layer l + 1
    (and the final output) shows the kernel's mask exactly."""
    dev = _card()
    B, N, nl, rate = 32, 240, 16, 0.4
    g = torch.Generator().manual_seed(5)
    h0 = (torch.rand(B, N, H, generator=g) + 0.5).to(dev)
    adj = torch.rand(B, N, N, generator=g).to(dev) / N
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    W = torch.zeros(nl, 2 * H, H, device=dev)
    seed = torch.tensor([987654321987], dtype=torch.int64, device=dev)
    res = [torch.zeros(B, nl, N, H, device=dev) for _ in RESIDUALS]
    out = gcnii_stack_fwd(adj, h0, h0, W, theta, alpha=1.0, reason=False,
                          rate=rate, seed=seed, residuals=res)
    torch.cuda.synchronize()
    for l in range(nl):
        got = (res[0][:, l + 1] if l + 1 < nl else out) != 0
        want = philox.keep_mask(seed, rate, B, l, N, H)
        assert torch.equal(got, want), l
    frac = float(want.float().mean())
    assert abs(frac - (1 - rate)) < 0.01


@pytest.mark.gpu
def test_plain_ops_switch_runs_the_plain_versions_on_the_card():
    dev = _card()
    g = torch.Generator().manual_seed(7)
    B, L = 2, 5
    xg = torch.randn(B, L, 3 * H, generator=g).to(dev)
    w = (torch.rand(3 * H, H, generator=g) * 0.2 - 0.1).to(dev).t()
    b = torch.zeros(3 * H, device=dev)
    mask = torch.ones(B, L, device=dev)
    before = bigru_layer_fwd.launches
    with plain_ops():
        got = bigru_layer_fwd(xg, xg, w, b, w, b, mask)
    assert bigru_layer_fwd.launches == before      # nothing was launched
    want = bigru_layer_plain(xg, xg, w, b, w, b, mask)
    for a, c in zip(got, want):
        assert torch.equal(a, c)                   # the same plain ops
    bigru_layer_fwd(xg, xg, w, b, w, b, mask)      # the switch is off again
    assert bigru_layer_fwd.launches == before + 1


@pytest.mark.gpu
def test_backward_on_the_card_reaches_every_parameter():
    """The regression test for kernel outputs detached from autograd: one
    training step of the 16-layer flagship on the card gives every
    parameter a nonzero gradient, through kernels C and D, and the same
    gradients as the plain versions under autograd."""
    from mmdfn_torch import ops
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.data.batching import collate
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs

    dev = _card()
    cfg = flagship_config(seed=3)
    cfg.class_weight = True
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=3, n_test=1,
                                      min_len=5, max_len=9, seed=3)
        dias = IEMOCAPDataset(f"{tmp}/iem.pkl", train=True).dialogues()
    inputs = prepare_inputs(collate(dias, 3, 9, 2), dev)

    def step(plain):
        tr = Trainer(cfg, device=dev)
        before = dict(ops.launch_counts())
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(inputs, seed=11)
        else:
            loss, _ = tr.train_step(inputs, seed=11)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}, used

    loss, grads, used = step(plain=False)
    assert all(v > 0 for v in used.values()), used
    for name, g in grads.items():
        assert g is not None and bool(g.abs().max() > 0), name
    ref_loss, ref, used = step(plain=True)
    assert not any(used.values())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= 1e-4 * scale, name
