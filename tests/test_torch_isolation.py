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


def test_other_graph_types_name_the_later_slice():
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.models import DialogueGNN

    for kw in (dict(graph_type="GF2"), dict(graph_type="relation"),
               dict(base_model="GRU"), dict(mm_fusion_mthd="gated"),
               dict(use_speaker=True)):
        with pytest.raises(NotImplementedError, match="later slice"):
            DialogueGNN.from_config(ExperimentConfig(**kw))
