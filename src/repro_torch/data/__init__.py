from .rmat import load_rmat_graph, rmat_edges  # noqa: F401
