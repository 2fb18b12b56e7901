"""Whole runs of the harness on the CPU at a tiny size, past its look for
a card: the program's group step and evaluation against the reference, the
check failing on each fault a training cell can have, the rate's
arithmetic, what is loaded after a run, and cells, mixes and metrics found
as files."""

import json
import subprocess
import sys

import pytest

from portbench import check
from portbench.harness import forbidden_modules, run_cell
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("config", ["tiny_iemocap", "tiny_meld"])
def test_reference_agrees_with_the_group_step(root, config):
    out = run_cell(tiny.cell(config), 2 ** 31 + 5, 0.5, False, "cpu",
                   root=root)
    assert out["correct"], out["checks"]
    for name in check.NAMES:
        assert out["numbers"][name] < 2e-5
    w = out["window"]
    # all the work over all the time: K x dialogues stepped / seconds
    assert out["metrics"]["train_dialogues_per_s"]["value"] == \
        pytest.approx(2 * w["dialogues"] / w["seconds"])
    assert w["steps"] >= 1 and w["unwarmed_steps"] == 0
    assert out["attempted"] == 2 * w["steps"] and out["failed"] == 0
    assert not forbidden_modules()


@pytest.mark.parametrize("fault,fails", [
    ("frozen", "change"), ("half_batch", "loss1"), ("answer", "eval0")])
def test_a_broken_step_is_not_correct(root, fault, fails):
    out = run_cell(tiny.cell("tiny_iemocap"), 11, 0.2, False, "cpu",
                   root=root, fault=fault)
    assert not out["correct"]
    c = out["checks"][fails]
    assert c["value"] > 10 * c["limit"]


def test_cells_mixes_and_metrics_found_as_files(root):
    (root / "metrics" / "window.steps.py").write_text(
        "def read(ctx):\n    return float(sum(u[0] == 'step' "
        "for u in ctx['units']))\n")
    (root / "metrics" / "nothing.py").write_text(
        "def read(ctx):\n    return None\n")
    traffic = json.loads((root / "traffic" / "tiny.json").read_text())
    traffic["batch_size"] = 3
    (root / "traffic" / "tiny3.json").write_text(json.dumps(traffic))
    conf = json.loads((root / "configs" / "tiny_iemocap.json").read_text())
    conf["model"]["Deep_GCN_nlayers"] = 1
    (root / "configs" / "tiny_one.json").write_text(json.dumps(conf))
    (root / "limits" / "tiny_one.tiny3.json").write_text(
        json.dumps(tiny.LIMITS))
    cell = dict(name="tiny_one.tiny3", config="tiny_one", traffic="tiny3")
    out = run_cell(cell, 3, 0.2, True, "cpu", root=root,
                   per_layer=[("window.steps", "steps"), ("nothing", "%")])
    assert out["correct"], out["checks"]
    assert out["metrics"]["window.steps"] == {
        "value": float(out["window"]["steps"]), "unit": "steps"}
    assert "nothing" not in out["metrics"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, portbench.follow, portbench.control, "
            "portbench.check; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'mmdfn_torch', 'mmdfn_tpu', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad))")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert got == "[]"


def test_run_refuses_without_a_card(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run

    monkeypatch.chdir(tiny.HERE.parent)
    assert run.main(["--workload", "iemocap_gdf16.grid16", "--seed", "1",
                     "--seconds", "1"]) == 2
