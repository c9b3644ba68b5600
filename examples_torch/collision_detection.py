"""Real-time collision detection on the port (paper §5.3): mot → ynet →
detect → store.

Twin of ``examples/collision_detection.py`` on ``repro_torch``.
Three-stage DFG over toy trajectory models on ``--device``; per-frame
latency reported with the platform-overhead share, mirroring Fig 11.

Run: PYTHONPATH=src python examples_torch/collision_detection.py
     [--device cuda]
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
    """The two trajectory models' weights, drawn from ``generator``."""
    return {"w_mot": torch.randn((512, 64), generator=generator,
                                 device=device) / 23.0,
            "w_ynet": torch.randn((16, 48), generator=generator,
                                  device=device) / 4.0}


def make_models(w: dict):
    """(mot, ynet): host arrays in, device tensors out."""
    dev = w["w_mot"].device

    def mot(frame):
        return torch.tanh(torch.as_tensor(frame, device=dev) @ w["w_mot"])

    def ynet(tracks):
        return torch.tanh(torch.as_tensor(tracks, device=dev) @ w["w_ynet"])

    return mot, ynet


def block_until_ready(t: torch.Tensor) -> torch.Tensor:
    """Wait for ``t``'s producers on the card (``jax.block_until_ready``)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def detect(preds) -> int:
    """Pairs of agents whose predicted paths come within 0.05."""
    p = np.asarray(preds).reshape(-1, 24, 2)
    hits = 0
    for i in range(p.shape[0]):
        for j in range(i + 1, p.shape[0]):
            if (np.linalg.norm(p[i] - p[j], axis=-1) < 0.05).any():
                hits += 1
    return hits


def make_lambdas(mot, ynet, stamps: dict, done: threading.Event) -> dict:
    """The DFG's vertex functions, timing their compute into ``stamps``."""

    def lam_mot(ctx, obj):
        stamps["m0"] = time.monotonic()
        block_until_ready(mot(obj.payload["frame"]))
        stamps["m1"] = time.monotonic()
        tracks = np.random.randn(obj.payload["agents"], 16).astype(np.float32)
        ctx.emit(obj.key.rsplit("/", 1)[-1], tracks, trigger=True)

    def lam_ynet(ctx, obj):
        stamps["y0"] = time.monotonic()
        preds = ynet(obj.payload).cpu().numpy()
        stamps["y1"] = time.monotonic()
        ctx.emit(obj.key.rsplit("/", 1)[-1], preds, trigger=True)

    def lam_detect(ctx, obj):
        stamps["d0"] = time.monotonic()
        hits = detect(obj.payload)
        stamps["d1"] = time.monotonic()
        ctx.emit(obj.key.rsplit("/", 1)[-1], np.int64(hits))
        done.set()

    return {"mot": lam_mot, "ynet": lam_ynet, "detect": lam_detect}


def make_dfg() -> DFG:
    dfg = DFG(name="rcd")
    dfg.add_vertex(Vertex("mot", "/rcd/frames", shard_workers=(0, 1)))
    dfg.add_vertex(Vertex("ynet", "/rcd/tracks", shard_workers=(2, 3)))
    dfg.add_vertex(Vertex("detect", "/rcd/preds", shard_workers=(4,)))
    dfg.add_vertex(Vertex("store", "/rcd/out"))
    dfg.add_edge("mot", "ynet")
    dfg.add_edge("ynet", "detect")
    dfg.add_edge("detect", "store")
    return dfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples_torch/collision_detection.py")

    mot, ynet = make_models(make_weights(
        torch.Generator(device=dev).manual_seed(1), dev))
    block_until_ready(mot(np.zeros((1, 512), np.float32)))   # warm up
    block_until_ready(ynet(np.zeros((4, 16), np.float32)))

    with tempfile.TemporaryDirectory() as d, \
         CascadeService(n_workers=5, log_dir=d) as svc:
        done = threading.Event()
        stamps: dict[str, float] = {}
        svc.deploy(make_dfg(), make_lambdas(mot, ynet, stamps, done))

        frame = np.random.randn(1, 512).astype(np.float32)
        for agents in (5, 10, 15):
            e2e, overhead = [], []
            for i in range(25):
                done.clear()
                t0 = time.monotonic()
                svc.trigger_put(f"/rcd/frames/f{i}",
                                {"frame": frame, "agents": agents})
                assert done.wait(5)
                dt = (time.monotonic() - t0) * 1e3
                comp = ((stamps["m1"] - stamps["m0"])
                        + (stamps["y1"] - stamps["y0"])
                        + (stamps["d1"] - stamps["d0"])) * 1e3
                e2e.append(dt)
                overhead.append(max(0.0, dt - comp))
            print(f"agents={agents:2d}  e2e median "
                  f"{statistics.median(e2e):6.2f} ms  platform overhead "
                  f"{statistics.median(overhead):5.2f} ms")
        print("OK")


if __name__ == "__main__":
    main()
