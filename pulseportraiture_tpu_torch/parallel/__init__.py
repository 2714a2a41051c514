"""Process-level scale-out of the port (``multihost``: process group,
deterministic work partitioning, bounded barriers).

The reference's device-mesh modules (``mesh.py``, ``sharded_fit.py``,
``multihost.global_mesh`` / ``distributed_sweep_fit``) are not ported
yet: they shard one fit's channel and bin axes with collectives inside
the solver, a design of its own.
"""
