"""PyTorch/CUDA port of the Cascade serving stack (``repro``'s sibling).

Imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of the JAX
package ``repro``, which stays the reference the port is held against.
"""
