"""Smart-farming pipeline on the port (paper §5.2): filter →
body-condition-score → store.

Twin of ``examples/smart_farming.py`` on ``repro_torch``.  Two real (tiny)
PyTorch models on ``--device`` deployed as DLL-style lambdas; frames stream
in via trigger puts and land, scored, in a volatile pool.  Prints the
Fig-10 style latency breakdown.

Run: PYTHONPATH=src python examples_torch/smart_farming.py [--device cuda]
"""
import argparse
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core import DFG, CascadeService, Vertex
from repro_torch.core.devstore import resolve_device


def make_weights(generator: torch.Generator, device) -> dict:
    """The two models' weights, drawn from ``generator`` on ``device``."""
    normal = lambda *shape: torch.randn(shape, generator=generator,
                                        device=device)
    return {"w_f1": normal(768, 64) / 28.0, "w_f2": normal(64, 2) / 8.0,
            "w_b1": normal(768, 128) / 28.0, "w_b2": normal(128, 5) / 12.0}


def make_models(w: dict):
    """(filter_model, bcs_model): host frames in, device class ids out."""
    dev = w["w_f1"].device

    def filter_model(x):   # "is there a valid animal in frame?"
        x = torch.as_tensor(x, device=dev)
        return torch.argmax(torch.relu(x @ w["w_f1"]) @ w["w_f2"], dim=-1)

    def bcs_model(x):      # body-condition score 0..4
        x = torch.as_tensor(x, device=dev)
        return torch.argmax(torch.relu(x @ w["w_b1"]) @ w["w_b2"], dim=-1)

    return filter_model, bcs_model


def make_lambdas(filter_model, bcs_model, stamps: dict,
                 done: threading.Event) -> dict:
    """The DFG's vertex functions, timing their model calls into
    ``stamps``."""

    def lam_filter(ctx, obj):
        stamps["f0"] = time.monotonic()
        keep = int(filter_model(obj.payload)[0]) >= 0
        stamps["f1"] = time.monotonic()
        if keep:
            ctx.emit(obj.key.rsplit("/", 1)[-1], obj.payload, trigger=True)

    def lam_bcs(ctx, obj):
        stamps["b0"] = time.monotonic()
        score = int(bcs_model(obj.payload)[0])
        stamps["b1"] = time.monotonic()
        ctx.emit(obj.key.rsplit("/", 1)[-1],
                 {"score": score, "rfid": "cow-042"})
        done.set()

    return {"filter": lam_filter, "bcs": lam_bcs}


def make_dfg() -> DFG:
    dfg = DFG(name="sf")
    dfg.add_vertex(Vertex("filter", "/sf/detect_animal", shard_workers=(0,)))
    dfg.add_vertex(Vertex("bcs", "/sf/assess_bcs", shard_workers=(1, 2)))
    dfg.add_vertex(Vertex("store", "/sf/save_image", replication=2))
    dfg.add_edge("filter", "bcs")
    dfg.add_edge("bcs", "store")
    return dfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples_torch/smart_farming.py")

    weights = make_weights(torch.Generator(device=dev).manual_seed(0), dev)
    filter_model, bcs_model = make_models(weights)
    frame = np.random.randn(1, 768).astype(np.float32)
    int(filter_model(frame)[0])            # warm up
    int(bcs_model(frame)[0])

    with tempfile.TemporaryDirectory() as d, \
         CascadeService(n_workers=4, log_dir=d) as svc:
        done = threading.Event()
        stamps: dict[str, float] = {}
        svc.deploy(make_dfg(),
                   make_lambdas(filter_model, bcs_model, stamps, done))

        e2e = []
        for i in range(50):
            done.clear()
            t0 = time.monotonic()
            svc.trigger_put(f"/sf/detect_animal/frame{i}", frame)
            assert done.wait(5)
            e2e.append((time.monotonic() - t0) * 1e3)
        compute = ((stamps["f1"] - stamps["f0"])
                   + (stamps["b1"] - stamps["b0"])) * 1e3
        med = statistics.median(e2e)
        print(f"frames: 50   e2e median: {med:.2f} ms   "
              f"model compute (last frame): {compute:.2f} ms   "
              f"forwarding share: {max(0.0, med - compute) / med:.0%}")
        result = svc.get("/sf/save_image/frame49")
        print(f"stored record: {result.payload}")
        print("OK")


if __name__ == "__main__":
    main()
