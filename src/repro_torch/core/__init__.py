"""Host-side core pieces the serving slice needs (copies of the JAX
package's plain-Python modules, whose package ``__init__`` imports jax)."""
