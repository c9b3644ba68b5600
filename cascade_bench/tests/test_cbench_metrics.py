"""The metric arithmetic: percentiles and rates over every request and the
whole window, the work functions against counts made by hand, and the
trace's reduction."""
import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from cascade_bench import readers, run, work
from cascade_bench.serve import Record, Run
from cascade_bench.trace import Trace, shortfall
from cascade_bench.traffic import Item

ROOT = Path(__file__).resolve().parents[2]
DS = json.loads((ROOT / "cascade_bench/configs/deepseek-moe-16b.json")
                .read_text())
ZB = json.loads((ROOT / "cascade_bench/configs/zamba2-2.7b.json")
                .read_text())


def _run(records, ticks, end=10.0, config=DS):
    r = Run(cell={}, config=config, mix={}, seconds=end)
    r.start, r.end = 0.0, end
    r.ticks = ticks
    r.records = records
    return r


def _rec(index, due, prompt_len, token_ticks, max_new=None, done=False):
    item = Item(index, due, np.zeros(prompt_len, np.int32),
                max_new or len(token_ticks))
    rec = Record(item, due)
    rec.token_ticks = list(token_ticks)
    rec.done = done
    return rec


def test_p90_is_the_inclusive_decile():
    vals = [float(x) for x in range(1, 11)]
    assert readers.p90(vals) == pytest.approx(
        statistics.quantiles(vals, n=10, method="inclusive")[8])
    assert readers.p90(vals) == pytest.approx(9.1)
    assert readers.p90([]) is None and readers.p90([3.0]) == 3.0


def test_ttft_counts_every_request_due():
    # ticks end at 1, 2, 3; a request with no token counts to the end
    ticks = [(0.5, 1.0, 0, True), (1.5, 2.0, 0, True), (2.5, 3.0, 0, True)]
    recs = [_rec(0, 0.25, 4, [0, 1, 2]), _rec(1, 1.0, 4, [2]),
            _rec(2, 9.0, 4, [])]
    r = _run(recs, ticks)
    assert readers.ttfts(r) == [0.75, 2.0, 1.0]


def test_tpot_is_first_to_last_over_the_gaps():
    ticks = [(0, 1.0, 0, True), (1, 2.0, 0, True), (2, 4.0, 0, True)]
    recs = [_rec(0, 0.0, 4, [0, 1, 2]), _rec(1, 0.0, 4, [2]),
            _rec(2, 0.0, 4, [1, 2])]
    r = _run(recs, ticks)
    assert readers.tpots(r) == [1.5, 2.0]     # the one-token request: none


def test_tpot_median_over_every_request():
    ticks = [(0, 1.0, 0, True), (1, 2.0, 0, True), (2, 4.0, 0, True)]
    recs = [_rec(0, 0.0, 4, [0, 1, 2]), _rec(1, 0.0, 4, [1, 2]),
            _rec(2, 0.0, 4, [0, 2]), _rec(3, 0.0, 4, [2])]
    r = _run(recs, ticks)
    assert run.reader("tpot_p50_s")(r) == pytest.approx(2.0)
    assert run.reader("tpot_p90_s.chat")(r) == pytest.approx(2.8)


def test_rate_is_every_token_over_the_whole_window():
    ticks = [(0, 1.0, 0, True), (1, 2.0, 0, True)]
    recs = [_rec(0, 0.0, 4, [0, 1]), _rec(1, 0.0, 4, [1])]
    r = _run(recs, ticks, end=6.0)
    assert run.reader("output_tokens_per_s")(r) == pytest.approx(0.5)


def test_queue_wait_to_the_first_tick_with_a_slot():
    ticks = [(0, 1.0, 0, True), (1, 2.5, 0, True)]
    a, b = _rec(0, 0.5, 4, [1]), _rec(1, 2.0, 4, [])
    a.issued_tick = 1
    r = _run([a, b], ticks, end=4.0)
    assert readers.queue_waits(r) == [2.0, 2.0]


def test_tick_period_of_the_ticks_that_dispatched():
    ticks = [(0, 0.02, 0, True), (0.1, 0.14, 0, True), (0.2, 0.9, 0, False)]
    r = _run([], ticks)
    assert run.reader("tick_period_ms.tpot")(r) == pytest.approx(30.0)


def test_k1_call_by_hand():
    # one block of 16, 2 kv heads of D 4, 3 tokens seeing 6 pairs, 4 q heads
    flops, nbytes = work.k1_call(blocks=1, visible=6, tokens=3, rows=2,
                                 nb=8, bs=16, h=4, kv=2, d=4)
    assert flops == 6 * 4 * 4 * 4
    assert nbytes == 16 * 2 * 2 * 4 * 2 + 2 * 3 * 4 * 4 * 2 + 2 * 8 * 4 \
        + 2 * 3 * 4


def test_k3_call_by_hand():
    # one chunk of 3 tokens: 6 causal pairs
    H, P, N = 2, 4, 5
    flops, _ = work.k3_call(1, 3, H, P, N, 256)
    assert flops == 2 * N * 6 + H * (2 * P * 6 + 4 * 3 * P * N)
    two, _ = work.k3_call(2, 3, H, P, N, 256)
    assert two == 2 * flops


def test_deepseek_flops_per_token_by_hand():
    d, H, D, E, ff, dff = 2048, 16, 128, 64, 1408, 10944
    attn = 4 * d * H * D
    moe = d * E + 6 * 3 * d * ff + 2 * 3 * d * ff
    total = 28 * attn + 3 * d * dff + 27 * moe
    assert work.linear_flops_per_token(DS["model"]) == 2 * total
    # with the two embedding tables, the published 2.8 B activated
    assert 2.7e9 < total + 2 * 102400 * d < 2.9e9


def test_zamba2_flops_per_token_by_hand():
    d, di, N, Hs, W = 2560, 5120, 64, 80, 4
    mamba = d * (2 * di + 2 * N + Hs) + di * d + W * (di + 2 * N)
    shared = 2 * d * 32 * 160 * 3 + 32 * 160 * d + 2 * 2 * d * 10240 \
        + 10240 * d
    assert work.linear_flops_per_token(ZB["model"]) == \
        2 * (54 * mamba + 9 * shared)


def test_tick_work_follows_the_prompt_stream():
    # request 0 (prompt 5) prefills 3 + 2 over ticks 0-1 and emits at 1, 2;
    # request 1 (prompt 4) prefills at tick 2 and emits there
    recs = [_rec(0, 0.0, 5, [1, 2]), _rec(1, 0.0, 4, [2])]
    ticks = [(0, 1, 3, True), (1, 2, 2, True), (2, 3, 4, True)]
    w = work.tick_work(_run(recs, ticks))
    assert [x.prefill for x in w] == [[(5, 0, 3)], [(5, 3, 2)], [(4, 0, 4)]]
    assert [x.decode for x in w] == [[], [], [5]]
    assert [x.emitted for x in w] == [0, 1, 2]
    # tick 1: 2 tokens at positions 3, 4 see 4 + 5 positions
    assert w[1].visible() == 2 * 3 + 3
    assert w[2].visible() == 6 + 4 * 5 // 2


def test_model_flops_of_a_tick_by_hand():
    m = DS["model"]
    w = work.TickWork(decode=[9], prefill=[(4, 0, 4)], emitted=2)
    lin = work.linear_flops_per_token(m)
    att = 4.0 * 16 * 128 * (10 + 10) * 28
    head = 2.0 * 2048 * 102400
    assert work.model_flops(m, w) == pytest.approx(5 * lin + att + 2 * head)


def test_a_roofline_share_needs_a_trace():
    r = _run([_rec(0, 0.0, 4, [0])], [(0, 1, 4, True)])
    assert readers.k1_roofline(r) is None and readers.idle_share(r) is None
    r.trace = Trace(kernels=[("ragged_tc_kernel", 0, 10**9)],
                    window=(0, 2 * 10**9))
    share = readers.k1_roofline(r)
    assert 0 < share < 100
    assert readers.idle_share(r) == pytest.approx(50.0)


def test_trace_breakdown_names_gaps_by_span():
    tr = Trace(kernels=[("a", 0, 10), ("b", 5, 20), ("a", 50, 60)],
               spans=[("tick", 0, 40), ("wait", 40, 50)], window=(0, 100))
    assert tr.busy_s() == pytest.approx(30e-9)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "a"
    assert bd["device_ops"][0][1] == pytest.approx(20e-9)
    # the gaps: 60-100 (no span), 20-50 (mid 35: tick)
    assert [g[0] for g in bd["idle_gaps"]] == ["harness", "tick"]
    assert bd["idle_gaps"][0][1] == pytest.approx(40e-9)


def test_trace_shortfall_counts_the_ending_kernel():
    tr = Trace(kernels=[("ragged_combine_kernel", 0, 1)] * 9)
    assert shortfall(tr, {"ragged_paged_attention": 10, "flash": 3}) == \
        {"ragged_paged_attention": 1}


def test_every_metric_has_its_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(m["name"]))
