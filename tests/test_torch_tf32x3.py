"""The f32 mode's products on the tensor cores, emulated on the CPU: kernels
B and D (``csrc/gemm_f32.cuh``, ``gemm_tc_kernel``) split each f32 operand
as x = big + small, big = tf32(x) and small = tf32(x - big), each rounded
to nearest with ties away from zero (``cvt.rna.tf32.f32``), and on
m16n8k8 tiles, 8 of k at a time, sum small_a big_b, big_a small_b and
big_a big_b into a partial sum, which an f32 add puts into the
accumulator.  The tensor cores add each tile's 8 exact products to their
f32 input rounding toward zero; these tests emulate that (each step's sum
exact in float64, then rounded toward zero to f32) at the benchmark
cells' product shapes and through a 16-layer stack forward of the plain
model, against float64: the split reconstructs x to 2^-22, the three
products keep f32's accuracy (within 8x a plain f32 product's own error,
and within the card checks' tolerances), one TF32 product does not (at
least 30x the three products' error), which is why the kernels take
three, and the three summed straight into the accumulator, each sum
rounded toward zero, lose several times more than through the partial
sum, which is why the kernels keep one."""

import pytest
import torch

from chip_smoke import KERNEL_B_RTOL, KERNEL_D_RTOL
from mmdfn_torch.ops import gcnii_stack_plain

H = 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small products: one torch thread per test worker (see the other
    # port tests)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 stored significand bits) as
    ``cvt.rna.tf32.f32`` rounds it: half a TF32 unit (bit 12) added to the
    magnitude, the 13 low bits cleared (ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def rz(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded to f32 toward zero, as the tensor cores round
    a product's sum."""
    r = x.float()
    over = r.double().abs() > x.abs()
    r[over] = torch.nextafter(r[over], torch.zeros_like(r[over]))
    return r


def mma_sum(terms, K: int, partial: bool = True) -> torch.Tensor:
    """The f32 accumulator after each k8 step: for each (a, b) of
    ``terms`` in order, the tile's 8 exact products (a, b TF32 values:
    exact in float64) added to the running sum and rounded toward zero;
    with ``partial`` that sum starts at 0 each step and an f32 add (to
    nearest) puts it into the accumulator, else it is the accumulator."""
    a0, b0 = terms[0]
    acc = torch.zeros(a0.shape[0], b0.shape[1], dtype=torch.float32)
    for k in range(0, K, 8):
        part = torch.zeros_like(acc) if partial else acc
        for a, b in terms:
            part = rz(part.double()
                      + a[:, k:k + 8].double() @ b[k:k + 8].double())
        acc = (acc.double() + part.double()).float() if partial else part
    return acc


def prod_3xtf32(a: torch.Tensor, b: torch.Tensor,
                partial: bool = True) -> torch.Tensor:
    """a @ b as the tensor-core core computes it: the small terms first."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return mma_sum([(as_, bb), (ab, bs), (ab, bb)], a.shape[1], partial)


def prod_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 product (what TF32 alone keeps)."""
    return mma_sum([(tf32_rna(a), tf32_rna(b))], a.shape[1])


def prod_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def prod_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.double() @ b.double()


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10   # a TF32 unit at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0e-39, -0.0])
    got = tf32_rna(x)
    assert got.tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp,
                            float(tf32_rna(torch.tensor([3.0e-39]))), -0.0]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_reconstructs_x_to_2_pow_22():
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(200_000, generator=g)
         * torch.exp2(torch.randint(-60, 60, (200_000,), generator=g)))
    big, small = split(x)
    for t in (big, small):
        assert (t.view(torch.int32) & 0x1FFF).eq(0).all()   # TF32 values
    gap = (x.double() - big.double() - small.double()).abs()
    assert (gap <= 2.0 ** -22 * x.double().abs()).all()
    assert float((gap / x.double().abs()).max()) > 2.0 ** -26   # not exact


def _operands(K: int, N: int, seed: int):
    """(M, K) and (K, N) operands as the cells' products meet them: the
    layer's state (O(1), both signs) against weights of torch's default
    scale, and a normalised adjacency against the state where K is the
    nodes (288: IEMOCAP's bucket 96)."""
    g = torch.Generator().manual_seed(seed)
    M = 288
    if K == 288:
        a = torch.rand(M, K, generator=g) / K
        b = torch.randn(K, N, generator=g)
    else:
        a = torch.randn(M, K, generator=g)
        b = (torch.rand(K, N, generator=g) * 2 - 1) / K ** 0.5
    return a, b


@pytest.mark.parametrize("K, N", [(200, 400), (288, H), (400, 2 * H)])
def test_three_tf32_products_keep_f32_accuracy(K, N):
    # K = 200: F1 / P1 ([h | lh] [W_ih; W_hh]) and F3 / P3; 288: F2 / P2,
    # P6 (adj over the nodes); 400: P7 (dgates [W_ih^T | W_hh^T])
    a, b = _operands(K, N, K)
    want = prod_f64(a, b)
    scale = float(want.abs().max())
    direct = lambda x, y: prod_3xtf32(x, y, partial=False)
    err = {name: float((fn(a, b).double() - want).abs().max())
           for name, fn in (("f32", prod_f32), ("3xtf32", prod_3xtf32),
                            ("tf32", prod_tf32), ("3xtf32 direct", direct))}
    assert err["3xtf32"] <= 8 * err["f32"], err
    assert err["3xtf32"] <= KERNEL_B_RTOL * scale, (err, scale)
    assert err["3xtf32"] <= KERNEL_D_RTOL * scale, (err, scale)
    assert err["tf32"] >= 30 * err["3xtf32"], err
    assert err["3xtf32 direct"] >= 3 * err["3xtf32"], err


def _stack(prod, adj, h, h0, W, theta, ih, hh, b, alpha, dtype):
    """The GCNII stack with the reason-LSTM (ops/gcnii.py's plain update,
    no dropout), its products as kernel B runs them: F1 [h | lh] [W_ih;
    W_hh], F2 adj h1, F3 [hi | h0] W[l]; the rest in ``dtype``."""
    c = lambda t: t.to(dtype)
    adj, h, h0, W, theta, ih, hh, b = map(c, (adj, h, h0, W, theta, ih, hh,
                                              b))
    wl = torch.cat([ih, hh])
    lh = torch.zeros_like(h)
    lc = torch.zeros_like(h)
    for l in range(W.shape[0]):
        q = h
        gates = c(prod(torch.cat([h, lh], 1), wl)) + b
        i, f, gg, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        lc = f * lc + i * torch.tanh(gg)
        lh = o * torch.tanh(lc)
        hi = c(prod(adj, lh))
        support = c(prod(torch.cat([hi, h0], 1), W[l]))
        r = (1.0 - alpha) * hi + alpha * h0
        h = torch.relu(theta[l] * support + (1.0 - theta[l]) * r) + q
    return h


def test_three_tf32_products_through_a_16_layer_stack():
    # one dialogue of IEMOCAP's bucket 96 (N = 288 nodes), 16 layers
    g = torch.Generator().manual_seed(16)
    N, nl, alpha = 288, 16, 0.2
    adj = torch.rand(N, N, generator=g) / N
    h0 = torch.relu(torch.randn(N, H, generator=g))
    h = h0.clone()
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1)
    W, ih, hh, b = u(nl, 2 * H, H), u(H, 4 * H), u(H, 4 * H), u(4 * H)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0)
    args = (adj, h, h0, W, theta, ih, hh, b, alpha)
    want = _stack(prod_f64, *args, torch.float64)
    got = {name: _stack(fn, *args, torch.float32)
           for name, fn in (("f32", prod_f32), ("3xtf32", prod_3xtf32),
                            ("tf32", prod_tf32))}
    scale = float(want.abs().max())
    err = {k: float((v.double() - want).abs().max()) for k, v in got.items()}
    # the emulation's stack is the plain model's (other sums, same update)
    plain = gcnii_stack_plain(adj[None], h[None], h0[None], W, theta, ih, hh,
                              b, alpha=alpha, reason=True)[0]
    assert float((plain - got["f32"]).abs().max()) <= KERNEL_B_RTOL * scale
    assert err["3xtf32"] <= 8 * err["f32"], err
    assert err["3xtf32"] <= KERNEL_B_RTOL * scale, (err, scale)
    assert err["tf32"] >= 30 * err["3xtf32"], err


@pytest.mark.parametrize("nl, reason", [(16, True), (64, False)])
def test_tc_products_counts_the_f32_modes_tiled_products(nl, reason):
    # ops.gcnii_tc_products: kernel B's three (two without the LSTM)
    # products a layer, kernel D's seven (five) and its weight-gradient
    # products, in the f32 mode's tiled design; nothing else
    from mmdfn_torch.ops.gcnii import (gcnii_bwd_launches,
                                       gcnii_fwd_launches, tc_products)

    r = int(reason)
    fwd, bwd = gcnii_fwd_launches(nl, reason), gcnii_bwd_launches(nl, reason)
    assert tc_products(fwd, "f32", True) == (2 + r) * nl
    assert tc_products(bwd, "f32", True, 1 + r) == (5 + 2 * r) * nl + 1 + r
    assert tc_products(1, "f32", False) == 0   # resident, row-wise
    for mode in ("bf16", "bf16_scan"):
        assert tc_products(gcnii_fwd_launches(nl, reason, mode=mode), mode,
                           True) == 0
        assert tc_products(gcnii_bwd_launches(nl, reason, mode=mode), mode,
                           True, 1 + r) == 0
