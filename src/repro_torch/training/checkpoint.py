"""Checkpointing THROUGH the Cascade persistent log (§3.2/§3.6 applied).

Port of the JAX package's ``training/checkpoint.py``, over the port's
``core.log.PersistentLog``.  A checkpoint is an append of every leaf of a
state tree, then of a ``<prefix>/__meta__`` record: versions are free (the
log keeps every step's checkpoint with backpointer chains), and so is
temporal restore ("the checkpoint as of T").

Leaf encoding, as the reference's: the raw (little-endian) bytes, and in the
meta record the leaf's name (its path in the tree), shape and dtype.
bfloat16 and float8_e4m3fn leaves, which numpy lacks, are written as their
raw bits under the dtype names ``bfloat16`` / ``float8_e4m3fn`` (the names
the JAX package's numpy arrays carry), and restored to the same bits.

Trees are dicts, lists, tuples and NamedTuples (``TrainState``,
``OptState``) of tensors; a leaf's name is its path
(``repro_torch.tree.named_leaves``).
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.log import PersistentLog
from repro_torch.tree import named_leaves, tree_map

# dtype name -> (numpy dtype of the stored bits, torch dtype)
_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
_BY_TORCH = {dt: name for name, (_, dt) in _DTYPES.items()}


def _encode(t: torch.Tensor) -> tuple[bytes, str]:
    t = t.detach().contiguous().cpu()
    name = _BY_TORCH.get(t.dtype)
    if name is not None:
        bits = _DTYPES[name][0]
        arr = t.view(torch.int16 if bits == np.uint16 else torch.uint8
                     ).numpy().view(bits)
    else:
        arr = t.numpy()
        name = str(arr.dtype)
    return arr.tobytes(), name


def _decode(payload: bytes, rec: dict, like: torch.Tensor) -> torch.Tensor:
    # numpy knows "bfloat16" and "float8_e4m3fn" only where ml_dtypes is
    # loaded: read those as their raw bits
    bits, dt = _DTYPES.get(rec["dtype"], (rec["dtype"], None))
    arr = np.frombuffer(payload, dtype=bits).reshape(rec["shape"])
    t = torch.from_numpy(arr.copy())                # a writable copy
    if dt is not None:
        t = t.view(dt)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, log_path: str, prefix: str = "/ckpt") -> None:
        self.log = PersistentLog(log_path)
        self.prefix = prefix

    def save(self, step: int, tree: Any, *, wait: bool = True) -> None:
        meta = {"step": step, "leaves": []}
        for name, leaf in named_leaves(tree):
            payload, dtype = _encode(leaf)
            meta["leaves"].append({"name": name, "shape": list(leaf.shape),
                                   "dtype": dtype})
            self.log.append(f"{self.prefix}/{name}", payload,
                            wait_stable=False)
        self.log.append(f"{self.prefix}/__meta__", json.dumps(meta).encode(),
                        wait_stable=wait)

    def latest_step(self) -> int | None:
        m = self.log.latest(f"{self.prefix}/__meta__")
        return json.loads(m.payload)["step"] if m else None

    def restore(self, like: Any, *,
                at_time_ns: int | None = None) -> tuple[int, Any]:
        """Restore into the structure of ``like``: each leaf on its like's
        device, in its dtype.  ``at_time_ns`` uses the temporal index for
        time-travel restore (stable-prefix semantics)."""
        get = (lambda k: self.log.get_time(k, at_time_ns)) if at_time_ns \
            else self.log.latest
        meta_obj = get(f"{self.prefix}/__meta__")
        if meta_obj is None:
            raise FileNotFoundError("no checkpoint found")
        meta = json.loads(meta_obj.payload)
        by_name = {rec["name"]: rec for rec in meta["leaves"]}
        out = iter([_decode(get(f"{self.prefix}/{name}").payload,
                            by_name[name], leaf)
                    for name, leaf in named_leaves(like)])
        return meta["step"], tree_map(lambda _: next(out), like)

    def close(self) -> None:
        self.log.close()
