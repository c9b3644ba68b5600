"""End-to-end driver on the port: train a ~100M-param LM for a few hundred
steps with the full substrate — synthetic data pipeline, AdamW, remat,
fault-tolerant loop with Cascade-persistent checkpoints, straggler
monitor.

Twin of ``examples/train_lm.py`` on ``repro_torch``: the same lm100m
config (8L × d512 × ffn2048, 32k vocab, f32), seeded random weights on
``--device``; every attention layer runs K2 under autograd.

Run: PYTHONPATH=src python examples_torch/train_lm.py [--steps 200]
     [--device cuda]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core.devstore import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, synthetic_batch
from repro_torch.training.ft import FaultTolerantLoop, StepMonitor
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train import init_train_state, make_train_step

# ~100M params: 8L × d512 × ffn2048, 32k vocab
CFG = ModelConfig(name="lm100m", family="dense", n_layers=8, d_model=512,
                  n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
                  dtype="float32", q_chunk=128)


def batches(cfg: ModelConfig, dcfg: DataConfig, device):
    """The synthetic stream, each step's batch as tensors on ``device``."""
    i = 0
    while True:
        yield {k: torch.from_numpy(v).to(device)
               for k, v in synthetic_batch(cfg, dcfg, i).items()}
        i += 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples_torch/train_lm.py")

    cfg = CFG
    print(f"params: {cfg.param_count()/1e6:.0f}M")

    opt = get_optimizer("adamw", lr=3e-4, warmup_steps=20)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, opt)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq)

    losses = []

    def on_metrics(step_i, metrics, dt):
        losses.append(float(metrics["loss"]))
        if step_i % 10 == 0 or step_i <= 3:
            print(f"step {step_i:4d}  loss {losses[-1]:.3f}  "
                  f"grad_norm {float(metrics['grad_norm']):.2f}  "
                  f"{dt*1e3:.0f} ms")

    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(os.path.join(d, "ckpt.log"))
        loop = FaultTolerantLoop(step, state, ckpt=ckpt, ckpt_every=50,
                                 monitor=StepMonitor(),
                                 on_straggler=lambda s: print(
                                     f"straggler @ {s}"))
        loop.run(batches(cfg, dcfg, dev), args.steps, metrics_cb=on_metrics)
        print(f"final loss: {losses[-1]:.3f} (start {losses[0]:.3f})")
        print(f"checkpointed through step {ckpt.latest_step()}")
        assert losses[-1] < losses[0]
        ckpt.close()
    print("OK")


if __name__ == "__main__":
    main()
