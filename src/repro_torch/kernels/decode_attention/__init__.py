"""Ragged paged attention over the quantizable KV block pool."""
