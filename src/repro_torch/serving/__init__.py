"""Paged serving: scheduler, KV block manager, drafts and the engine."""
