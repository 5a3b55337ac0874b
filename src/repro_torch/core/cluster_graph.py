"""Integer label codes shared by the engine, the crowd and the service
(the port's copy of ``repro/core/cluster_graph.py``'s constants)."""

UNKNOWN = -1
NEG = 0
POS = 1
