"""``python -m repro_torch.analysis <paths>``: the port's cascade-lint."""
from .runner import main

if __name__ == "__main__":
    raise SystemExit(main())
