"""Meshes of logical devices and the logical-axis sharding rules.

Port of the JAX package's ``launch/mesh.py`` and ``launch/sharding.py``:
``mesh`` builds meshes and carves disjoint serving slices, ``sharding``
resolves the models' logical axes to mesh axes and places tensors over a
mesh (``ShardedTensor``, the counterpart of a sharded ``jax.Array``).
"""
