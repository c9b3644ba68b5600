"""End-to-end driver on the port: a multi-tenant ServeNode on the Cascade
fast path.

Twin of ``examples/serve_cluster.py`` on ``repro_torch``.  One node — one
shared worker set, one store, one KV device store, on ``--device`` — hosts
TWO models side by side: a paged attention model ("light", gemma2-9b
SMOKE: K1 every tick) and a dense SSM model ("heavy", mamba2-1.3b SMOKE:
K3 in every prefill), each under its own ``/serve/<model>`` pools.  Three
serving patterns are exercised:

1. FIFO session affinity on the light deployment: every turn of a chat
   session lands on the same replica, in order, so the replica's prefix
   trie serves warm turns from cached KV blocks.
2. Cascade escalation (CascadeServe): requests go to the light model
   first; when the gate trips — mean decode logprob below a threshold,
   read from the per-token scores the engine surfaced in-dispatch — the
   request is escalated via an internal trigger_put into the heavy
   deployment's pool.
3. Bounded admission (MultiTASC++): the light tier's per-replica queues
   get a watermark; an overload burst is redirected to less-loaded
   siblings and then shed with a structured reason — tail latency stays
   bounded, and the cascade fails shed requests over to the heavy tier so
   nothing is dropped.

Run: PYTHONPATH=src python examples_torch/serve_cluster.py [--device cuda]
"""
import argparse
import statistics

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.devstore import resolve_device
from repro_torch.core.pools import DispatchPolicy
from repro_torch.models import init_params
from repro_torch.serving.cluster import CascadeGate, CascadeRoute, ServeNode


def deploy_tiers(node: ServeNode, light_cfg, light_params, heavy_cfg,
                 heavy_params):
    """The light (paged, FIFO sessions) and heavy (dense) deployments, two
    replicas each."""
    light = node.deploy("light", light_cfg, light_params, n_replicas=2,
                        n_slots=4, max_len=64, policy=DispatchPolicy.FIFO)
    heavy = node.deploy("heavy", heavy_cfg, heavy_params, n_replicas=2,
                        n_slots=4, max_len=64)
    assert light.paged and not heavy.paged
    return light, heavy


def chat_sessions(node, light, vocab: int, rng: np.random.Generator,
                  turns: int = 3) -> dict:
    """Pattern 1: three sessions x ``turns`` turns on the light tier, each
    turn's prompt the session's whole history plus six new tokens.  Returns
    the replicas each session's turns landed on and the tier's stats."""
    sessions = ["alice", "bob", "carol"]
    history = {s: rng.integers(0, vocab, (8,)).astype(np.int32)
               for s in sessions}
    for t in range(turns):
        for s in sessions:
            light.submit(s, f"{s}-t{t}", history[s], max_new_tokens=6)
        node.run_until_drained()
        for s in sessions:
            reply = light.result(f"{s}-t{t}")
            new = rng.integers(0, vocab, (6,)).astype(np.int32)
            history[s] = np.concatenate(
                [history[s], reply.astype(np.int32), new])
    return {"replicas": {s: sorted({light.routed[f"{s}-t{t}"]
                                    for t in range(turns)})
                         for s in sessions},
            "stats": light.stats()}


def escalate(node, light, heavy, vocab: int, rng: np.random.Generator,
             n: int = 12) -> CascadeRoute:
    """Pattern 2: calibrate the gate on the light model's own confidence,
    then route ``n`` prompts — uncertain answers re-run on the heavy
    model, confident ones never touch it."""
    probe_scores = []
    probe = lambda req: probe_scores.append(req.mean_logprob())
    light.on_done.append(probe)
    for i in range(8):
        light.submit("cal", f"cal{i}",
                     rng.integers(0, vocab, (8,)).astype(np.int32),
                     max_new_tokens=6)
    node.run_until_drained()
    light.on_done.remove(probe)
    gate = CascadeGate("logprob", threshold=statistics.median(probe_scores))
    route = CascadeRoute(light, heavy, gate)
    for i in range(n):
        route.submit(f"u{i % 4}", f"r{i}",
                     rng.integers(0, vocab, (int(rng.integers(4, 12)),))
                     .astype(np.int32), max_new_tokens=6)
    node.run_until_drained()
    return route


def overload(node, light, route, vocab: int, rng: np.random.Generator,
             n: int = 24) -> None:
    """Pattern 3: watermark the light tier and send a burst of ``n``."""
    light.watermark = 6
    for i in range(n):
        route.submit(f"burst{i % 3}", f"b{i}",
                     rng.integers(0, vocab, (8,)).astype(np.int32),
                     max_new_tokens=4)
    node.run_until_drained()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples_torch/serve_cluster.py")

    light_cfg = get_config("gemma2-9b", smoke=True)
    heavy_cfg = get_config("mamba2-1.3b", smoke=True)
    light_params = init_params(
        light_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    heavy_params = init_params(
        heavy_cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    vocab = light_cfg.vocab_size
    rng = np.random.default_rng(0)

    with ServeNode(n_workers=2, device=dev) as node:
        light, heavy = deploy_tiers(node, light_cfg, light_params,
                                    heavy_cfg, heavy_params)

        # ---- 1. FIFO chat sessions on the light model: affinity + prefix
        # reuse (each turn's prompt extends the session's full history)
        chat = chat_sessions(node, light, vocab, rng)
        st = chat["stats"]
        for s, replicas in chat["replicas"].items():
            assert len(replicas) == 1, "FIFO must pin a session to one replica"
        print(f"[light/FIFO] {st['requests']} turns over "
              f"{st['n_replicas']} replicas "
              f"(per replica: {st['per_replica_requests']})")
        print(f"             prefix reuse: {st['prefix_hit_tokens']} of "
              f"{st['prompt_tokens']} prompt tokens from cached blocks")
        assert st["prefix_hit_tokens"] > 0, "warm turns must hit the trie"
        assert st["host_syncs"] == st["ticks"]   # paged invariant

        # ---- 2. cascade escalation
        n = 12
        route = escalate(node, light, heavy, vocab, rng, n)
        rs = route.stats()
        print(f"[cascade]    {rs['escalated']}/{rs['requests']} escalated "
              f"(rate {rs['escalation_rate']:.2f}, gate "
              f"mean-logprob < {rs['threshold']:.3f})")
        assert all(route.result(f"r{i}") is not None for i in range(n))
        hs = heavy.stats()
        assert hs["host_syncs"] == hs["decode_ticks"] + hs["prefill_batches"]

        # ---- 3. bounded admission: shed/redirect keep the queues bounded
        # while the cascade fails shed requests over to the heavy tier
        overload(node, light, route, vocab, rng)
        ls = light.stats()
        print(f"[overload]   shed={ls['shed']} redirected={ls['redirected']} "
              f"(watermark {light.watermark}); all "
              f"{sum(route.result(f'b{i}') is not None for i in range(24))}"
              f"/24 answered")
        assert all(len(route.result(f"b{i}")) == 4 for i in range(24)), \
            "a shed request must fail over to the heavy tier, not vanish"
        print("OK")


if __name__ == "__main__":
    main()
