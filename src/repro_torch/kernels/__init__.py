"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its
plain PyTorch version.

  cem_keys       fused coarsen + key pack            csrc/cem_keys.cu
  segment_stats  segment sums (GROUP BY core)        csrc/segment_sums.cu
                 fast-path scatter merge              csrc/scatter_merge.cu
                 partitioned fast-path scatter merge  csrc/scatter_merge_parts.cu
                 canonical chunked query sums         csrc/chunk_sums.cu
  logistic_grad  Newton terms of the propensity fit   csrc/logistic_grad.cu
  knn_topk       k nearest valid controls (matching)  csrc/knn_topk.cu
  greedy_sweep   the sweep of matching without        csrc/greedy_sweep.cu
                 replacement (not a TPU kernel)

``build.py`` compiles the sources with ``nvcc`` at first use and loads them
through ``ctypes``; nothing is built or imported from a GPU toolchain when
this package is imported. The wrappers are imported from their modules
(``from repro_torch.kernels.knn_topk import knn_topk``): several share
their module's name, so the package does not re-export them.
"""
