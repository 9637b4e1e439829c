from .rmat import load_rmat_graph, rmat_edges  # noqa: F401
from .pipeline import SyntheticTokens, shard_batch  # noqa: F401
