"""The port stands alone: no JAX, no flax, nothing of ``mmdfn_tpu``; and
its entry points refuse to fall back to the CPU silently."""

import ast
from pathlib import Path

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "mmdfn_tpu")


def _port_files():
    return sorted((ROOT / "mmdfn_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    # the multi-device layer, whose rank functions spawned ranks import
    for part in ("runtime/mesh.py", "runtime/launch.py",
                 "parallel/graph_parallel.py", "parallel/workers.py"):
        assert ROOT / "mmdfn_torch" / part in files, part
    bad = [(str(f.relative_to(ROOT)), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_a_card(monkeypatch):
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.serve import StreamingSession
    from mmdfn_torch.weights import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_config(nlayers=1)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSession(model, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSession(model, cfg, device="cuda")
    assert StreamingSession(model, cfg, device="cpu").device.type == "cpu"


def test_trainer_and_training_cli_raise_without_a_card(monkeypatch,
                                                        tmp_path):
    from mmdfn_torch.cli import run_train_erc
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_config(nlayers=1)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, device=device)
    assert Trainer(cfg, device="cpu").device.type == "cpu"
    path = str(tmp_path / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=2, n_test=1, min_len=2,
                                  max_len=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train_erc.main(["--data_dir", path, "--epochs", "1",
                            "--Deep_GCN_nlayers", "1",
                            "--save_model_dir", str(tmp_path)])


def test_multi_device_groups_refuse_what_they_cannot_run(monkeypatch):
    """No group falls back: cuda ranks without a card, more NCCL ranks
    than cards, NCCL ranks on one named card and a mesh that is not the
    world's shape raise; a mesh needs a process group."""
    from mmdfn_torch.parallel import workers
    from mmdfn_torch.runtime import launch
    from mmdfn_torch.runtime.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(workers.run_jobs, 2, [], device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 cuda ranks need 2 cards"):
        launch.run(workers.run_jobs, 2, [], device="cuda")
    with pytest.raises(ValueError, match="cannot share"):
        launch.run(workers.run_jobs, 2, [], device="cuda:0")
    with pytest.raises(ValueError, match="share_device applies to cuda"):
        launch.run(workers.run_jobs, 2, [], device="cpu", share_device=True)
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh(2)
    # a world of one rank in this process: a 2-rank mesh does not fit it
    with pytest.raises(ValueError, match=r"n_data\*n_model=2 ranks, found 1"):
        launch.run(make_mesh, 1, 2)


def test_torchrun_ranks_are_counted_against_this_hosts_cards(monkeypatch):
    """Under ``torchrun`` a group may span hosts: its NCCL ranks are held
    against the cards of this host (``LOCAL_WORLD_SIZE``), not against the
    whole world, and the rank joins with its global rank and world."""
    from mmdfn_torch.runtime import launch

    joined = []
    monkeypatch.setattr(launch, "_in_process",
                        lambda fn, args, dev, backend, rank, world, init:
                        joined.append((backend, rank, world, init)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for k, v in dict(RANK="11", WORLD_SIZE="16", LOCAL_RANK="3",
                     LOCAL_WORLD_SIZE="8").items():
        monkeypatch.setenv(k, v)
    launch.run(print, 16, device="cuda")
    assert joined == [("nccl", 11, 16, "env://")]
    with pytest.raises(ValueError, match="torchrun started 16 ranks"):
        launch.run(print, 8, device="cuda")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "9")
    with pytest.raises(ValueError, match="9 cuda ranks need 9 cards on "
                                         "this host, found 8"):
        launch.run(print, 16, device="cuda")


def test_other_graph_types_name_the_later_slice():
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.models import DialogueGNN

    for kw, error, match in (
            (dict(multi_modal=False), ValueError, "no single stream"),
            (dict(mm_fusion_mthd="concat"), ValueError, "no single stream"),
            (dict(base_model="GRU"), ValueError, "feeds one stream"),
            (dict(base_model="DialogRNN"), NotImplementedError,
             "single-stream only"),
            (dict(graph_model=False), ValueError, "selects a baseline"),
            (dict(dataset="DailyDialogue"), ValueError, "DailyTrainer")):
        with pytest.raises(error, match=match):
            DialogueGNN.from_config(ExperimentConfig(**kw))
