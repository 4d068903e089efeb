"""Measurement tools of the PyTorch port, each `python -m
pyrhe_tpu_torch.bench.<name>`:

  timing         timers, bounds, the card's identity (shared by the rest)
  matvec         genotype matvec GFLOP/s of the streaming pass-1 body
  kernels        each CUDA kernel against its plain version and library call
  e2e            end-to-end phase times, repeated inside one call
  host_read      the host .bed read + clean pipeline against its threads
  staging        host-to-card copy rate, pinned and pageable, 1-4 streams
  scaling_study  e2e over a ladder of N x M, into docs/torch/

Every tool prints the card's name and power limit beside its numbers and
raises without a card unless the caller passes `--device cpu` (matvec,
e2e, host_read, scaling_study), whose times are host times.
"""
