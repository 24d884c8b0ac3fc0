"""The benchmark of piqp_tpu_torch on an NVIDIA H100: see ``run.py``."""
