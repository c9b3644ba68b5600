"""End-to-end driver on the port: serve a small LM with batched requests
on the Cascade fast path (the paper's hosting model applied to token
serving).

Twin of ``examples/serve_lm.py`` on ``repro_torch``.  A reduced
gemma2-family model (gemma2-9b SMOKE, seeded random weights) is hosted by
a ServeEngine on ``--device`` (continuous batching, paged KV; K1 attends
every tick, and on the card the tick is a CUDA graph); requests are routed
by the Cascade dispatch policies (FIFO pins a session to a replica; RR
load-balances).  Reports TTFT / TPOT.

Run: PYTHONPATH=src python examples_torch/serve_lm.py [--device cuda]
"""
import argparse
import statistics

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.devstore import resolve_device
from repro_torch.core.pools import DispatchPolicy
from repro_torch.models import init_params
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import Request, Scheduler


def make_engine(cfg, params, device) -> ServeEngine:
    return ServeEngine(cfg, params, n_slots=4, max_len=64,
                       scheduler=Scheduler(policy=DispatchPolicy.FIFO,
                                           n_replicas=1), device=device)


def submit_requests(engine: ServeEngine, vocab: int, n_requests: int,
                    rng: np.random.Generator) -> list[Request]:
    """``n_requests`` prompts of 4-11 random tokens, 8 new tokens each,
    over three sessions."""
    reqs = []
    for i in range(n_requests):
        prompt = rng.integers(0, vocab, size=(int(rng.integers(4, 12)),))
        reqs.append(Request(request_id=f"req-{i}",
                            session_key=f"user-{i % 3}",
                            prompt=prompt.astype(np.int32),
                            max_new_tokens=8))
        engine.submit(reqs[-1])
    return reqs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples_torch/serve_lm.py")

    cfg = get_config("gemma2-9b", smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    engine = make_engine(cfg, params, dev)
    n_requests = 10
    submit_requests(engine, cfg.vocab_size, n_requests,
                    np.random.default_rng(0))
    engine.run_until_drained()

    s = engine.stats
    print(f"requests: {n_requests}   prefills: {s.prefills}   "
          f"tokens out: {s.tokens_out}   engine ticks: {s.ticks}")
    print(f"TTFT  median: {statistics.median(s.ttft_s)*1e3:.1f} ms "
          f"(includes the first ticks' warm-up)")
    print(f"TPOT  median: {statistics.median(s.tpot_s)*1e3:.1f} ms/token "
          f"across batched decode")
    assert s.prefills == n_requests
    assert s.tokens_out >= n_requests * 8
    print("OK")


if __name__ == "__main__":
    main()
