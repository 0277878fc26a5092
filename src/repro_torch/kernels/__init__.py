"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its
plain PyTorch version.

  cem_keys       fused coarsen + key pack            csrc/cem_keys.cu
  segment_stats  segment sums (GROUP BY core)        csrc/segment_sums.cu
                 fast-path scatter merge              csrc/scatter_merge.cu
                 partitioned fast-path scatter merge  csrc/scatter_merge_parts.cu
                 canonical chunked query sums         csrc/chunk_sums.cu
  logistic_grad  Newton terms of the propensity fit   csrc/logistic_grad.cu

``build.py`` compiles the sources with ``nvcc`` at first use and loads them
through ``ctypes``; nothing is built or imported from a GPU toolchain when
this package is imported.
"""
