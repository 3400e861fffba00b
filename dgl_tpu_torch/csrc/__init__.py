"""Host-side native code of the port: the neighbour samplers (``graph_ops.cpp``)."""
