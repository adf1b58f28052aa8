"""Parallel serving: the shard mesh and the state's sharded layout
(``mesh.py``), the sharded step with the owner exchange (``step.py``), and
blockwise attention over long histories (``ring_attention.py``; its
sharded forms wait for ROADMAP A7d)."""
