"""Kernel B's host-side plan: which design each shape takes, how many CUDA
kernels each launches, and the resident design's split of the channels
over a cluster and its shared memory.  CPU only: the kernels themselves
are held against their plain version on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from mmdfn_torch.data.batching import SERVE_BUCKETS
from mmdfn_torch.ops import gcnii_stack_plain
from mmdfn_torch.ops.gcnii import (DESIGNS, RESIDENT, RESIDENT_CLUSTER,
                                   ROWWISE, SMEM_MAX, TILED, _design,
                                   _forward, gcnii_fwd_launches,
                                   resident_slices, resident_smem_bytes)

SMS = 132   # an H100's multiprocessors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the design measured fastest for one dialogue at each serve bucket (N =
# 3 L nodes, 16 layers, reason; chip_smoke.py's kernel B cases)
SERVE_CHOICE = {8: RESIDENT, 16: RESIDENT, 32: RESIDENT, 64: RESIDENT,
                128: RESIDENT, 200: ROWWISE}


@pytest.mark.parametrize("L", SERVE_BUCKETS)
def test_a_serve_forward_takes_the_measured_design(L):
    assert _design(1, 3 * L, SMS) == SERVE_CHOICE[L]


def test_the_training_batch_takes_the_tiled_products():
    assert _design(32, 240, SMS) == TILED


@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
def test_the_batch_picks_by_the_measured_crossover(B):
    # N = 240: the resident design below the crossover, the tiled products
    # from it on (chip_smoke.py's table at N = 240)
    want = TILED if B >= 16 else RESIDENT
    assert _design(B, 240, SMS) == want


@pytest.mark.parametrize("reason", [True, False])
@pytest.mark.parametrize("nl", [1, 2, 16, 64])
def test_each_design_counts_its_launches(nl, reason):
    assert gcnii_fwd_launches(nl, reason, RESIDENT) == 1
    assert gcnii_fwd_launches(nl, reason, ROWWISE) == 1 + nl + int(reason)
    assert gcnii_fwd_launches(nl, reason, TILED) == \
        1 + (3 if reason else 2) * nl


@pytest.mark.parametrize("H", [8, 64, 100, 127, 128])
def test_the_cluster_splits_the_channels_exactly_once(H):
    slices = resident_slices(H)
    assert len(slices) == RESIDENT_CLUSTER
    owned = [c for c0, S in slices for c in range(c0, c0 + S)]
    assert owned == list(range(H))
    sizes = [S for _, S in slices]
    assert max(sizes) <= 8 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("N", [3 * L for L in SERVE_BUCKETS] + [129, 240])
def test_the_resident_design_fits_shared_memory_where_it_is_chosen(N):
    if _design(1, N, SMS) == RESIDENT:
        assert resident_smem_bytes(N, 100) <= SMEM_MAX
    # and the plan grows with the rows, as the kernel's layout does
    assert resident_smem_bytes(N + 4, 100) - resident_smem_bytes(N, 100) \
        == 4 * 7 * 8 * 4


def test_no_design_is_picked_where_its_memory_does_not_fit():
    big = next(N for N in range(600, 2000, 4)
               if resident_smem_bytes(N, 100) > SMEM_MAX)
    assert _design(1, big, SMS) != RESIDENT


@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_cpu_tensors_take_the_plain_version_in_every_design(design):
    rng = np.random.default_rng(7)
    B, N, H, nl = 2, 9, 100, 2
    T = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    adj, h, W = T(B, N, N), T(B, N, H), T(nl, 2 * H, H)
    theta = torch.tensor([0.4, 0.2])
    lstm = (T(H, 4 * H), T(H, 4 * H), T(4 * H))
    got = _forward(adj, h, h, W, theta, *lstm, alpha=0.2, reason=True,
                   rate=0.0, seed=None, residuals=None,
                   design=DESIGNS[design])
    want = gcnii_stack_plain(adj, h, h, W, theta, *lstm, alpha=0.2,
                             reason=True)
    assert torch.equal(got, want)
