"""Scale-out of the port: ``mesh`` (a ('subint', 'chan', 'bin') grid of
devices and the placement of a fit batch on it), ``sharded_fit`` (the
batched portrait fit sharded over a mesh, and IPTA sweeps) and
``multihost`` (the process group: deterministic work partitioning,
bounded barriers, and sweeps whose batch spans processes).
"""
