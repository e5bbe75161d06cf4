"""Distribution of the z-first engine over a device mesh: the transports
(``mesh``: ``ShardMesh``, ``DistMesh``), the exchange tally report
(``analyze``) and the scaling harness (``scaling``)."""
