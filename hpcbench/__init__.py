"""The benchmark of hpccg_tpu_torch (``python3 -m hpcbench.run``; see
README.md). It imports the port, plain torch and numpy, never JAX or the
JAX package ``hpccg_tpu``."""
