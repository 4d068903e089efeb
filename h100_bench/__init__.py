"""The H100 benchmark of pyrhe_tpu_torch (README.md); run.py runs a cell."""
