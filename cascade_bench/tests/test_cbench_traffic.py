"""The traffic generator: every seed offers the same totals, in its own
order, and a mix's file fits its cells' engines."""
import json
from pathlib import Path

import numpy as np
import pytest

from cascade_bench import traffic

ROOT = Path(__file__).resolve().parents[2]
BIG_SEED = 2 ** 31 + 4_000_000_123

CHAT = {"loop": "open", "rate_per_s": 4.0,
        "prompt": {"dist": "lognormal", "median": 1020, "sigma": 1.0,
                   "min": 16, "max": 3072},
        "output": {"dist": "lognormal", "median": 129, "sigma": 0.9,
                   "min": 8, "max": 1024},
        "strata": 16}
DOC = {"loop": "closed", "pool": 256,
       "prompt": {"dist": "uniform", "min": 2048, "max": 3968},
       "output": {"dist": "uniform", "min": 32, "max": 128}, "strata": 16}


def _lengths(items):
    return ([len(i.prompt) for i in items], [i.max_new for i in items])


@pytest.mark.parametrize("mix", [CHAT, DOC], ids=["open", "closed"])
def test_same_seed_same_schedule(mix):
    a = traffic.schedule(mix, BIG_SEED, 40, 1000)
    b = traffic.schedule(mix, BIG_SEED, 40, 1000)
    assert _lengths(a) == _lengths(b)
    assert [i.due_s for i in a] == [i.due_s for i in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", [CHAT, DOC], ids=["open", "closed"])
def test_every_seed_offers_the_same_totals(mix):
    a = traffic.schedule(mix, 11, 40, 1000)
    b = traffic.schedule(mix, BIG_SEED, 40, 1000)
    pa, oa = _lengths(a)
    pb, ob = _lengths(b)
    assert sorted(pa) == sorted(pb) and sorted(oa) == sorted(ob)
    assert pa != pb                       # the order is the seed's
    if mix["loop"] == "open":
        # the gaps, the last one running to the window's end
        ga = np.sort(np.diff([i.due_s for i in a] + [40.0]))
        gb = np.sort(np.diff([i.due_s for i in b] + [40.0]))
        assert np.allclose(ga, gb)


def test_open_loop_count_and_due_times():
    items = traffic.schedule(CHAT, 5, 40, 1000)
    assert len(items) == 160              # rate x seconds
    due = [i.due_s for i in items]
    assert due[0] == 0.0 and due == sorted(due)
    assert due[-1] < 40


def test_stratified_draws_are_the_quantiles():
    v = traffic.stratified({"dist": "uniform", "min": 0, "max": 100}, 4)
    assert v.tolist() == [12, 38, 62, 88]
    ln = traffic.stratified(CHAT["prompt"], 1001)
    assert ln[500] == 1020                # the median is the median
    assert ln.min() >= 16 and ln.max() == 3072


def test_each_round_holds_every_stratum():
    n, strata = 160, 16
    order = traffic.rounds(n, strata, np.random.default_rng(3))
    assert sorted(order.tolist()) == list(range(n))
    groups = np.array_split(np.arange(n), strata)
    which = {int(i): s for s, g in enumerate(groups) for i in g}
    for r in range(n // strata):
        chunk = order[r * strata:(r + 1) * strata]
        assert sorted(which[int(i)] for i in chunk) == list(range(strata))


def test_token_ids_lie_in_the_vocabulary():
    items = traffic.schedule(DOC, BIG_SEED, 40, 517)
    ids = np.concatenate([i.prompt for i in items])
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 517


def test_a_mix_too_long_for_the_engine_is_refused():
    with pytest.raises(ValueError, match="max_len"):
        traffic.check_fits(CHAT, 4000)
    traffic.check_fits(CHAT, 4096)


def test_every_cell_fits_its_engine():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    confs = {c["name"]: json.loads((ROOT / c["file"]).read_text())
             for c in spec["configs"]}
    for cell in spec["workloads"]:
        conf = confs[cell["config"]]
        if conf["mode"] != "serve":
            continue
        mix = traffic.load_mix(cell["traffic"])
        traffic.check_fits(mix, conf["engine"]["max_len"])
        assert mix["prompt"]["max"] + mix["output"]["max"] <= \
            conf["context_length"]
