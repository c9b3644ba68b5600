"""Quickstart on the port: the Cascade K/V store + lambda DFG in ~60 lines.

Twin of ``examples/quickstart.py`` on ``repro_torch``.  Builds a two-stage
pipeline (uppercase → reverse → persistent store), puts an object through
it, and shows versioned + temporal reads — the paper's §3.1 "porting an
application is trivial" flow.  The pipeline is host work (the port's copy
of the host core); ``--device`` is checked as at every port entry point.

Run: PYTHONPATH=src python examples_torch/quickstart.py [--device cuda]
"""
import argparse
import tempfile
import time

from repro_torch.core import DFG, CascadeService, Persistence, Vertex
from repro_torch.core.devstore import resolve_device


def make_dfg() -> DFG:
    """upper → reverse → out (persistent, two replicas)."""
    dfg = DFG(name="quickstart")
    dfg.add_vertex(Vertex("upper", "/qs/upper"))
    dfg.add_vertex(Vertex("reverse", "/qs/reverse"))
    dfg.add_vertex(Vertex("out", "/qs/out",
                          persistence=Persistence.PERSISTENT, replication=2))
    dfg.add_edge("upper", "reverse")
    dfg.add_edge("reverse", "out")
    return dfg


# thin lambda wrappers using the SDK context
def lam_upper(ctx, obj):
    ctx.emit(obj.key.rsplit("/", 1)[-1], obj.payload.upper(), trigger=True)


def lam_reverse(ctx, obj):
    ctx.emit(obj.key.rsplit("/", 1)[-1], obj.payload[::-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device, "examples_torch/quickstart.py")

    with tempfile.TemporaryDirectory() as logdir, \
         CascadeService(n_workers=3, log_dir=logdir) as svc:
        # 1. describe the DFG, 2. deploy the lambdas
        svc.deploy(make_dfg(), {"upper": lam_upper, "reverse": lam_reverse})

        # 3. fire an object through the fast path
        svc.inject("quickstart", "greeting", b"hello cascade")
        time.sleep(0.05)
        out = svc.get("/qs/out/greeting")
        print(f"result: {out.payload!r} (version {out.version})")

        # 4. versions + temporal reads come for free on persistent pools
        for i in range(3):
            svc.put("/qs/out/greeting", f"edit-{i}".encode())
            time.sleep(0.002)
        latest = svc.get("/qs/out/greeting")
        first = svc.store.get_version("/qs/out/greeting", 0)
        asof = svc.store.get_time("/qs/out/greeting", out.timestamp_ns)
        print(f"latest:  {latest.payload!r} (v{latest.version})")
        print(f"v0:      {first.payload!r}")
        print(f"temporal as-of first write: {asof.payload!r}")
        assert asof.payload == out.payload
        print("OK")


if __name__ == "__main__":
    main()
