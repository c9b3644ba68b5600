"""Host-side core of the port: the store's import closure (objects,
versioning, the persistent log, pools, placement, the dispatcher and the
store with its ``SpillPool``) and the path trie, copied from the JAX
package's plain-Python modules, whose package ``__init__`` imports jax."""
