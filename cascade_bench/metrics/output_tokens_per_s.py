"""output_tokens_per_s: every token served in the window over the window, tokens/s."""
from cascade_bench import readers


def read(run):
    return sum(len(r.token_ticks) for r in run.records) / (run.end - run.start)
