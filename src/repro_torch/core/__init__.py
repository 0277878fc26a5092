# The online causal engine's ingest -> ate() path in PyTorch (replicated
# and key-range partitioned layouts), with its coarsening, key, group-by,
# CEM, estimator and cuboid building blocks, and the streaming propensity
# model it refits. Counterpart of repro.core for the ported slice.
from repro_torch.core.coarsen import CoarsenSpec, coarsen
from repro_torch.core.keys import KeyCodec
from repro_torch.core import groupby
from repro_torch.core.cem import CEMGroups, make_codec
from repro_torch.core.ate import ATEEstimate, estimate_ate_from_stats
from repro_torch.core.propensity import (LogisticModel, StreamStats,
                                         fit_logistic, predict_ps,
                                         propensity_scores, warm_refit)
from repro_torch.core import cube
from repro_torch.core.online import (DeltaReport, OnlineEngine,
                                     PartitionedOnlineEngine,
                                     PoisonBatchError)

__all__ = [
    "CoarsenSpec", "coarsen", "KeyCodec", "groupby",
    "CEMGroups", "make_codec", "ATEEstimate", "estimate_ate_from_stats",
    "LogisticModel", "StreamStats", "fit_logistic", "predict_ps",
    "propensity_scores", "warm_refit",
    "cube", "DeltaReport", "OnlineEngine", "PartitionedOnlineEngine",
    "PoisonBatchError",
]
