"""On the card: the check's control (the reference in TF32, the precision
below the configurations' f32) fails the cell's limits, and so does half
of each batch left out, at the cells' widths and depth with K = 2."""

import json

import pytest

from portbench import check, follow
from portbench.harness import HERE, load_json


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["iemocap_gdf16.grid16",
                                  "meld_gdf64.grid16"])
def test_control_and_fault_fail_the_limits(card, cell):
    config, traffic_name = cell.split(".")
    conf = load_json(HERE, "configs", config)
    traffic = dict(load_json(HERE, "traffic", traffic_name), K=2,
                   ref_block=2)
    limits = load_json(HERE, "limits", cell)
    ref = follow.run(conf, traffic, 17, card)
    again = follow.run(conf, traffic, 17, card)
    same = check.numbers(again, ref, ref["umasks"])
    assert check.verdict(same, limits), same
    for kw in (dict(tf32=True), dict(half_batch=True)):
        got = check.numbers(follow.run(conf, traffic, 17, card, **kw), ref,
                            ref["umasks"])
        assert not check.verdict(got, limits), (kw, json.dumps(got))
