"""graph_build_s: host seconds of the port's graph build (bidirect,
self-loops, ``from_edges``' sorts and row splits, or the sampler's CSR),
ended by a synchronise. Moves setup_s."""


def read(t):
    return t.graph_build_s
