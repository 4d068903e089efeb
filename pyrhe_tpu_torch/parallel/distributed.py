"""Multi-process bootstrap of the port: one process per GPU.

Counterpart of pyrhe_tpu/parallel/distributed.py and mesh.py. The process
group comes from the environment: torchrun's RANK / WORLD_SIZE /
LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or the JAX package's
COORDINATOR_ADDRESS (host:port) / NUM_PROCESSES / PROCESS_ID. The backend
is NCCL when the engine runs on CUDA and gloo on the CPU. There is no mesh
object: the jackknife blocks shard over the ranks of the world
(parallel/sharded.py).

Pattern (the same program on every rank):

    torchrun --nproc_per_node G -m pyrhe_tpu_torch.cli ...

or from Python:

    from pyrhe_tpu_torch.parallel import distributed
    distributed.initialize("cuda")       # also selects cuda:LOCAL_RANK
    eng = Engine(data, spec, cfg)        # device "cuda" = that card
    eng.run_sharded()
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0     # a collective that waits longer raises


def _env():
    """(rank, world size, "host:port") from the environment, or None."""
    e = os.environ
    if "WORLD_SIZE" in e and "MASTER_PORT" in e:
        return (int(e.get("RANK", "0")), int(e["WORLD_SIZE"]),
                f"{e.get('MASTER_ADDR', 'localhost')}:{e['MASTER_PORT']}")
    if "NUM_PROCESSES" in e and "COORDINATOR_ADDRESS" in e:
        return (int(e.get("PROCESS_ID", "0")), int(e["NUM_PROCESSES"]),
                e["COORDINATOR_ADDRESS"])
    return None


def env_world_size() -> int:
    """The world size the environment asks for; 1 when it asks for none."""
    env = _env()
    return env[1] if env is not None else 1


def local_rank() -> int:
    """This process's card on its host: LOCAL_RANK, else the rank modulo
    the visible card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    env = _env()
    rank = env[0] if env is not None else 0
    return rank % max(1, torch.cuda.device_count())


def rank_device() -> torch.device:
    """cuda:LOCAL_RANK, the card of this rank."""
    return torch.device("cuda", local_rank())


def backend_for(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    kind = torch.device("cuda" if device in ("auto", "gpu") else device).type
    return "nccl" if kind == "cuda" else "gloo"


def initialize(device="cuda", timeout_s: float = TIMEOUT_S) -> None:
    """Build the process group from the environment (a no-op when it
    exists): NCCL for device "cuda" (which also makes cuda:LOCAL_RANK the
    current device), gloo for "cpu"; every collective times out after
    timeout_s. Raises when the environment names no process group, or when
    NCCL is asked for without a card."""
    if dist.is_initialized():
        return
    env = _env()
    if env is None:
        raise RuntimeError(
            "no process group in the environment: set RANK, WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT (torchrun does), or "
            "COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID")
    rank, size, addr = env
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs CUDA, but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def destroy() -> None:
    """Tear the process group down, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
