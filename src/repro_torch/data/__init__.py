"""Data substrate: synthetic corpora, tree datasets, prefetching loader."""

from repro_torch.data.synthetic import (lm_batches, synthetic_corpus,
                                        token_batch_specs)
from repro_torch.data.trees import (TreeDataset, sst_like_dataset,
                                    tree_fc_dataset, var_len_chains)
from repro_torch.data.loader import (ComposedBatchSource, PrefetchLoader,
                                     ShardedSource)

__all__ = ["lm_batches", "synthetic_corpus", "token_batch_specs",
           "TreeDataset", "sst_like_dataset", "tree_fc_dataset",
           "var_len_chains", "ComposedBatchSource", "PrefetchLoader",
           "ShardedSource"]
