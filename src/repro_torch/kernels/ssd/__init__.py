"""Mamba-2 SSD chunked scan (state carry across chunks, optional h0 and
D-term)."""
