"""RecSys substrate: sparse embedding tables + two-tower retrieval.

Counterpart of `repro/recsys/`. The EmbeddingBag's lookup goes through
the fused CUDA kernel of `kernels/embedding_bag` on the card.
"""
from repro_torch.recsys.embedding_bag import EmbeddingBag  # noqa: F401
from repro_torch.recsys.two_tower import TwoTower, TwoTowerConfig  # noqa: F401
