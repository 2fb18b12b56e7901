"""Start K ranks of a process group for a function of the package, or join
the group ``torchrun`` started (it sets ``RANK`` and ``WORLD_SIZE``).

The JAX package has no counterpart: its mesh lives in one process.  Here
each rank is a process:

    results = run(fn, 2, *args, device="cpu")     # fn(*args) on 2 ranks

* ``device="cpu"``: gloo, every rank on the host;
* ``device="cuda"``: NCCL, one rank per card; more ranks on a host than
  cards raise, as ``make_mesh`` raises in JAX (under ``torchrun`` the
  host's ranks are ``LOCAL_WORLD_SIZE``, so a group may span hosts);
* ``share_device=True``: gloo, every rank on the card ``device`` names
  (``"cuda:1"``), or with ``"cuda"`` rank r on card r mod count, so that
  one card can check a multi-rank run.  Two ranks on one card measure
  sharing, not scaling.  The CLIs ask for it by naming one card
  (:func:`names_one_card`).

Nothing falls back from one of these to another.  Spawned ranks meet in a
``file://`` store in a temporary directory (no TCP port, so concurrent
test workers cannot race for one); a group of one rank runs in this
process.  On a card the kernels are built here before the ranks start,
so that K ranks do not start K concurrent ``nvcc`` runs of each source.
Each spawned rank reads ``fn`` and its arguments from a file the
launcher writes (``torch.save``), so that it holds its own copy of them:
``spawn``'s own pickling would put the arguments' CPU tensors in shared
memory, and ranks that train a module they were given would then step
one set of weights each, all at once.  Each rank returns ``fn``'s result
through a file the launcher reads back, in rank order.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist


def names_one_card(device: str) -> bool:
    """Whether ``device`` names one card (``"cuda:0"``): the CLIs then run
    every rank on it, sharing it."""
    dev = torch.device(device)
    return dev.type == "cuda" and dev.index is not None


def _backend(dev: torch.device, n_ranks: int, share_device: bool) -> str:
    """The group's backend, for ``n_ranks`` ranks on this host."""
    if dev.type == "cpu":
        if share_device:
            raise ValueError("share_device applies to cuda ranks")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    if share_device:
        return "gloo"
    cards = torch.cuda.device_count()
    if dev.index is not None and n_ranks > 1:
        raise ValueError(f"{n_ranks} NCCL ranks cannot share {dev}; pass "
                         "share_device=True to run them on it over gloo")
    if n_ranks > cards:
        raise ValueError(
            f"{n_ranks} cuda ranks need {n_ranks} cards on this host, found "
            f"{cards}; "
            "pass share_device=True to run them on the cards there are over "
            "gloo (a check, not a measure of scaling)")
    return "nccl"


def _set_card(dev: torch.device, rank: int) -> None:
    """Rank ``rank``'s card: the one ``dev`` names, else the rank's (mod
    the count, for ranks that share the cards)."""
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else rank
        torch.cuda.set_device(index % torch.cuda.device_count())
        torch.cuda.init()


def _in_process(fn: Callable, args: tuple, device: torch.device,
                backend: str, rank: int, n_ranks: int,
                init_method: str) -> Any:
    """``fn(*args)`` in this process as one rank of the group."""
    _set_card(device, int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=n_ranks)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, n_ranks: int, device: torch.device,
               backend: str, store: str, out_dir: str, threads: int) -> None:
    """One spawned rank: ``fn(*args)`` (from the launcher's file) in the
    group, its result to a file."""
    torch.set_num_threads(threads)
    fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                          weights_only=False)
    result = _in_process(fn, args, device, backend, rank, n_ranks,
                         f"file://{store}")
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run(fn: Callable, n_ranks: int, *args, device: str = "cpu",
        share_device: bool = False) -> List[Any]:
    """``fn(*args)`` on each of ``n_ranks`` ranks; returns their results
    in rank order.  ``fn`` must be a module-level function of the package
    (spawned ranks import it by name).  Under ``torchrun`` this process is
    one rank of its group: ``n_ranks`` must be its world size, and the
    list holds this rank's result alone.

    Raises:
      ValueError: an unsatisfiable group (more NCCL ranks on a host than
        its cards, NCCL ranks on one named card, an unknown device, a world
        size other than torchrun's).
      RuntimeError: a cuda group without a card; a failed rank.
    """
    dev = torch.device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n_ranks:
            raise ValueError(f"torchrun started {world} ranks, the run needs "
                             f"{n_ranks}")
        here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = _backend(dev, here, share_device)
        return [_in_process(fn, args, dev, backend,
                            int(os.environ["RANK"]), world, "env://")]
    backend = _backend(dev, n_ranks, share_device)
    if dev.type == "cuda":
        from mmdfn_torch.ops import _build
        _build.build_all()
    tmp = tempfile.mkdtemp(prefix="mmdfn_ranks_")
    try:
        store = os.path.join(tmp, "store")
        if n_ranks == 1:
            return [_in_process(fn, args, dev, backend, 0, 1,
                                f"file://{store}")]
        threads = max(1, torch.get_num_threads() // n_ranks)
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        torch.multiprocessing.spawn(
            _rank_main, nprocs=n_ranks, join=True,
            args=(n_ranks, dev, backend, store, tmp, threads))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
