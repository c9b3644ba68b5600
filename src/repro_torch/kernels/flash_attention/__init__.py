"""Causal flash attention (GQA, sliding window, softcap), forward only."""
