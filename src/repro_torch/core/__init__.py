# The online causal engine's ingest -> ate() path in PyTorch (replicated
# and key-range partitioned layouts), with its coarsening, key, group-by,
# CEM, estimator and cuboid building blocks, and the streaming propensity
# model it refits; and the offline methods of the paper's Table 3 (CEM,
# EM, subclassification, NNM with and without replacement, AWMD).
# Counterpart of repro.core for the ported slices.
from repro_torch.core.coarsen import CoarsenSpec, coarsen, coarsen_columns
from repro_torch.core.keys import KeyCodec
from repro_torch.core import groupby
from repro_torch.core.cem import (CEMGroups, CEMResult, cem, cem_from_keys,
                                  exact_matching, make_codec, pack_keys)
from repro_torch.core.ate import (ATEEstimate, cem_weights,
                                  difference_in_means, estimate_ate,
                                  estimate_ate_from_stats)
from repro_torch.core.balance import awmd, raw_imbalance
from repro_torch.core.distance import (features, mahalanobis_transform,
                                       masked_covariance, pairwise_sqdist,
                                       ps_distance_features)
from repro_torch.core.matching import (MatchResult, greedy_nnmnr,
                                       knn_quadratic, knn_sorted_1d, nnmnr,
                                       nnmwr, nnmwr_att)
from repro_torch.core.subclassification import (SubclassResult, ntile,
                                                subclassify)
from repro_torch.core.propensity import (LogisticModel, StreamStats,
                                         fit_logistic, predict_ps,
                                         propensity_scores, warm_refit)
from repro_torch.core import cube
from repro_torch.core.online import (DeltaReport, OnlineEngine,
                                     PartitionedOnlineEngine,
                                     PoisonBatchError)

__all__ = [
    "CoarsenSpec", "coarsen", "coarsen_columns", "KeyCodec", "groupby",
    "CEMGroups", "CEMResult", "cem", "cem_from_keys", "exact_matching",
    "make_codec", "pack_keys", "ATEEstimate", "cem_weights",
    "difference_in_means", "estimate_ate", "estimate_ate_from_stats",
    "awmd", "raw_imbalance", "features", "mahalanobis_transform",
    "masked_covariance", "pairwise_sqdist", "ps_distance_features",
    "MatchResult", "greedy_nnmnr", "knn_quadratic", "knn_sorted_1d",
    "nnmnr", "nnmwr", "nnmwr_att", "SubclassResult", "ntile", "subclassify",
    "LogisticModel", "StreamStats", "fit_logistic", "predict_ps",
    "propensity_scores", "warm_refit",
    "cube", "DeltaReport", "OnlineEngine", "PartitionedOnlineEngine",
    "PoisonBatchError",
]
