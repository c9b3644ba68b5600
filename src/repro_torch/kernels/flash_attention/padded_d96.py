"""K2 at head_dim 96: its unpadded instantiation against the padded one.

``flash_attention.cu`` gives D = 96 its own instantiation (P·V 96 columns
wide).  Without it D = 96 would take ``launch<2, 128>``, the product padded
to DP = 128 columns.  This probe compiles the same source less its
``case 96`` beside the port's build, then runs both on the same inputs at
phi-3-vision-4.2b's score shapes (B = 1, S = 8192, H = K = 32, bf16, causal)
in turns (padded, unpadded, unpadded, padded).  Each output is held element
by element to one bf16 rounding of the plain version's f32 value, and each
time is the median of ``REPS`` launches timed by CUDA events with a cold
L2.  It prints the card's name and power limit, then one JSON line.

Run it on the card from the repo root:

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.padded_d96
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops, ref

SHAPE = ("phi-3-vision-4.2b", 1, 8192, 32, 32, 96)   # arch, B, S, H, K, D
CASE_96 = "    case 96: return launch<2, 96>(FA_ARGS);\n"
REPS = 10
ROUND_BF16 = 2.0 ** -8   # half a bf16 spacing, relative to the value
F32_TOL = 2e-5


def padded_kernel():
    """The kernel entry of ``flash_attention.cu`` built without its D = 96
    case, with the port's own entry's signature."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert src.count(CASE_96) == 1, "K2's D = 96 case moved"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "flash_attention_padded96.cu"
    cu.write_text(src.replace(CASE_96, ""))
    lib = build.BUILD_DIR / "libflash_attention_padded96.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    unpadded = ops._kernel()
    fn = ctypes.CDLL(str(lib)).flash_attention
    fn.argtypes, fn.restype = unpadded.argtypes, unpadded.restype
    return fn


def timed_ms(fn, flush: torch.Tensor) -> float:
    fn()
    pairs = []
    for _ in range(REPS):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()  # lint: allow-sync(a card probe; not on a tick)
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> None:
    dev = torch.device("cuda", 0)
    fns = {"unpadded": ops._kernel(), "padded": padded_kernel()}
    arch, B, S, H, K, D = SHAPE
    g = torch.Generator(device=dev).manual_seed(196)
    q, k, v = (torch.randn((B, S, n, D), generator=g, device=dev).to(
        torch.bfloat16) for n in (H, K, K))
    want32 = ref.attention_ref(q.float(), k.float(), v.float())
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    runs = {"padded": [], "unpadded": []}
    for name in ("padded", "unpadded", "unpadded", "padded"):
        ops._lib_fn = fns[name]
        try:
            out = ops.flash_attention(q, k, v)
            torch.cuda.synchronize()  # lint: allow-sync(a card probe)
            # lint: allow-sync(a card probe: the check reads one number)
            over = ((out.float() - want32).abs()
                    / (want32.abs() * ROUND_BF16 + F32_TOL)).max().item()
            assert over <= 1.0, (name, over)
            runs[name].append({"ms": timed_ms(
                lambda: ops.flash_attention(q, k, v), flush),
                "err_over_rounding_bound": over})
        finally:
            ops._lib_fn = fns["unpadded"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({
        "probe": "padded_d96", "arch": arch, "B": B, "S": S, "H": H, "K": K,
        "D": D, "dtype": "bfloat16", **runs,
        **{f"{name}_ms": statistics.median(r["ms"] for r in rs)
           for name, rs in runs.items()}}))


if __name__ == "__main__":
    main()
