"""Sources, the scoring engine (``engine.py``), the sharded engine
(``sharded_engine.py``: N shards in one process on one device, the
tiered store and the sequence kind included) and the fleet of processes
(``distributed.py``, ``cms_exchange.py``, ``elastic.py``)."""
