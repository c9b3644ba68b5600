"""The one traffic generator: a mix's data file (``traffic/<mix>.json``)
and a seed give the whole schedule of a run.

A mix fixes its totals and lets the seed choose only their order and the
token ids, so that every seed offers the same work:

- lengths are stratified draws: the n quantiles ``(i + 0.5) / n`` of the
  mix's distribution (log-normal or uniform), rounded and clipped;
- the seed permutes them in rounds: each round takes one value from each
  of ``strata`` equal slices of the sorted values, in a random order, so
  that any stretch of the schedule holds short and long requests alike;
- an open loop (``"loop": "open"``) sends N = rate x seconds requests whose
  gaps are the N stratified quantiles of an exponential, scaled so that
  they sum to the window, and permuted the same way: a Poisson process
  conditioned on its count and on its gaps, the first request due at 0;
- a closed loop (``"loop": "closed"``) has no due times: each client sends
  its next request when its last one completes, taking the next item.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass
class Item:
    index: int
    due_s: float | None      # from the window's start; None: closed loop
    prompt: np.ndarray        # (S,) int32 token ids
    max_new: int


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def stratified(spec: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 0.5) / n of ``spec``'s distribution, rounded
    and clipped to [min, max], in increasing order."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        v = spec["min"] + u * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


def rounds(n: int, strata: int, rng: np.random.Generator) -> np.ndarray:
    """A permutation of range(n) (indices into sorted values) in rounds:
    round r holds the r-th (shuffled) member of every stratum that has
    one, the strata in a random order."""
    groups = [rng.permutation(g) for g in
              np.array_split(np.arange(n), min(strata, n))]
    out = []
    for r in range(max(len(g) for g in groups)):
        for s in rng.permutation(len(groups)):
            if r < len(groups[s]):
                out.append(groups[s][r])
    return np.asarray(out, dtype=np.int64)


def count(mix: dict, seconds: float) -> int:
    """Requests a run of ``seconds`` offers: rate x seconds in an open
    loop, the mix's ``pool`` in a closed one."""
    if mix["loop"] == "open":
        return max(1, round(mix["rate_per_s"] * seconds))
    return int(mix["pool"])


def schedule(mix: dict, seed: int, seconds: float, vocab: int) -> list[Item]:
    """The run's requests in the order they are sent (open loop: by due
    time)."""
    rng = np.random.default_rng(seed)
    n = count(mix, seconds)
    strata = int(mix.get("strata", 16))
    prompts = stratified(mix["prompt"], n)[rounds(n, strata, rng)]
    outputs = stratified(mix["output"], n)[rounds(n, strata, rng)]
    due = [None] * n
    if mix["loop"] == "open":
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u)
        gaps *= seconds / gaps.sum()
        t = np.concatenate([[0.0], np.cumsum(gaps[rounds(n, strata, rng)])])
        due = [float(x) for x in t[:-1]]
    ids = rng.integers(0, vocab, size=int(prompts.sum()), dtype=np.int64)
    items, at = [], 0
    for i in range(n):
        s = int(prompts[i])
        items.append(Item(i, due[i], ids[at:at + s].astype(np.int32),
                          int(outputs[i])))
        at += s
    return items


def check_fits(mix: dict, max_len: int) -> None:
    """A mix whose longest prompt and output would not fit the engine's
    ``max_len`` is refused before any run."""
    need = mix["prompt"]["max"] + mix["output"]["max"]
    if need > max_len:
        raise ValueError(f"prompt max {mix['prompt']['max']} + output max "
                         f"{mix['output']['max']} = {need} > max_len "
                         f"{max_len}")
    if not math.isfinite(mix.get("rate_per_s", 1.0)):
        raise ValueError("rate_per_s must be finite")
