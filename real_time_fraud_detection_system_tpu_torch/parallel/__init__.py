"""Parallel serving: the shard mesh and the state's sharded layout
(``mesh.py``, with the fleet's merge and adoption), the sharded step with
the owner exchange (``step.py``), process groups and the 2-axis mesh
(``distributed.py``), and blockwise attention over long histories
(``ring_attention.py``; its sharded forms wait for ROADMAP A7d)."""
