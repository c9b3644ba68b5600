"""Decode attention: ragged paged attention over the quantizable KV block
pool (K1) and one-token attention over dense per-slot caches (K4)."""
