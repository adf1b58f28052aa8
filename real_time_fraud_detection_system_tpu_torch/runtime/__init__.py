"""Sources, the scoring engine (``engine.py``) and the sharded engine
(``sharded_engine.py``: N shards in one process on one device, the
tiered store included; the fleet of processes and the sequence kind over
shards are ROADMAP A7c and A7d)."""
