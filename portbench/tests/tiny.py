"""A tiny root of cells for the CPU tests: the two configurations at 2
layers, a few short dialogues, K = 2 and batches of 4, with the real
configuration files' widths, grids and laws otherwise."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
LIMITS = {"loss1": 1e-4, "grad": 1e-4, "change": 1e-4, "eval0": 1e-4}


def make_root(tmp: Path) -> Path:
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", tmp / "metrics", dirs_exist_ok=True)
    for name, src, law, spk in (
            ("tiny_iemocap", "iemocap_gdf16",
             dict(law="uniform", lo=4, hi=12), 2),
            ("tiny_meld", "meld_gdf64",
             dict(law="lognormal", median=5, sigma=0.6, lo=1, hi=20), 3)):
        conf = json.loads((HERE / "configs" / f"{src}.json").read_text())
        conf["model"]["Deep_GCN_nlayers"] = 2
        conf["data"] = dict(n_train=10, n_test=5, lengths=law,
                            speakers_per_dialogue=spk)
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(conf))
        (tmp / "limits" / f"{name}.tiny.json").write_text(json.dumps(LIMITS))
    traffic = json.loads((HERE / "traffic" / "grid16.json").read_text())
    traffic.update(K=2, batch_size=4, ref_block=1, warm_epochs=3,
                   trace_skip=1, trace_units=2)
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    return tmp


def cell(config: str) -> dict:
    return dict(name=f"{config}.tiny", config=config, traffic="tiny")
