"""Cluster environment adapter (counterpart of
`clip_event_tpu/parallel/cluster.py`; reference `MPIAdapter`,
`utils_MPIAdapter.py:12-144`).

Detects the launch environment and gives the rendezvous of
`torch.distributed.init_process_group`, one process per GPU:

  priority: torchrun (MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/LOCAL_RANK)
          → OpenMPI (OMPI_COMM_WORLD_*) → SLURM (SLURM_PROCID/NODELIST)
          → single process.

torchrun takes the place of the JAX package's first rung (its
JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID): a torchrun launch is
initialised even at a world of 1. Under OpenMPI the master address resolves
through the reference's sub-environment ladder (`utils_MPIAdapter.py:43-98`):
MASTER_ADDR env → Philly (PHILLY_CONTAINER_IP on rank 0, mpi4py-broadcast) →
AMLK8S/ITP (worker-0 IP from `/dlts-runtime/env/init.env`, with the
single-node fallback) → AML (`AZ_BATCH_MASTER_NODE`) → single-node loopback
→ hostfile → generic multi-node (`hostname -I` on rank 0,
mpi4py-broadcast). mpi4py is an optional import: without it the two
broadcast branches raise with instructions to export MASTER_ADDR from the
launcher instead.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
from typing import Optional

log = logging.getLogger(__name__)

_DEFAULT_PORT = "9010"


@dataclasses.dataclass
class ClusterSpec:
    coordinator_address: Optional[str]  # "host:port" of rank 0
    num_processes: Optional[int]
    process_id: Optional[int]
    source: str
    local_rank: int = 0  # the process's GPU on its node

    @property
    def is_distributed(self) -> bool:
        return bool(self.num_processes and self.num_processes > 1)


def detect_cluster() -> ClusterSpec:
    env = os.environ
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:  # torchrun
        return ClusterSpec(
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', _DEFAULT_PORT)}",
            int(env["WORLD_SIZE"]), int(env["RANK"]), "torchrun",
            int(env.get("LOCAL_RANK", "0")),
        )

    if "OMPI_COMM_WORLD_SIZE" in env:  # OpenMPI (utils_MPIAdapter.py:24-38)
        size = int(env["OMPI_COMM_WORLD_SIZE"])
        rank = int(env["OMPI_COMM_WORLD_RANK"])
        addr, port, source = _resolve_mpi_master(env, size, rank)
        return ClusterSpec(f"{addr}:{port}" if addr else None, size, rank, source,
                           int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")))

    if "SLURM_PROCID" in env:  # SLURM (reference utils.py:560-575)
        size = int(env.get("SLURM_NTASKS", "1"))
        rank = int(env["SLURM_PROCID"])
        nodelist = env.get("SLURM_NODELIST", "")
        addr = env.get("MASTER_ADDR")
        if not addr and nodelist:
            try:
                addr = subprocess.run(
                    ["scontrol", "show", "hostnames", nodelist],
                    capture_output=True, text=True, timeout=10,
                ).stdout.split("\n")[0].strip()
            except (OSError, subprocess.SubprocessError):
                addr = None
        port = env.get("MASTER_PORT", _DEFAULT_PORT)
        return ClusterSpec(f"{addr}:{port}" if addr else None, size, rank, "slurm",
                           int(env.get("SLURM_LOCALID", "0")))

    return ClusterSpec(None, 1, 0, "local")


# AMLK8S (ITP) writes the worker-0 IP into this per-node file
# (utils_MPIAdapter.py:55-73); overridable for tests.
ITP_ENV_FILE = "/dlts-runtime/env/init.env"


def _mpi_bcast(value, rank: int):
    """Broadcast rank 0's value as the reference does (`MPI.COMM_WORLD.bcast`,
    utils_MPIAdapter.py:53-54, 97-98); raise when mpi4py is missing."""
    try:
        from mpi4py import MPI  # type: ignore
    except ImportError:
        MPI = None
    if MPI is None:
        raise RuntimeError(
            "this MPI environment needs rank 0's address broadcast "
            "(mpi4py in the reference, utils_MPIAdapter.py:3) but mpi4py is "
            "not installed — export MASTER_ADDR/MASTER_PORT from the "
            "launcher instead"
        ) from None
    return MPI.COMM_WORLD.bcast(value, root=0)


def _resolve_mpi_master(env, size: int, rank: int):
    """(addr, port, source) under OpenMPI — the reference's sub-environment
    ladder (utils_MPIAdapter.py:43-98)."""
    local_size = int(env.get("OMPI_COMM_WORLD_LOCAL_SIZE", "1"))
    port = env.get("MASTER_PORT", _DEFAULT_PORT)

    if env.get("MASTER_ADDR"):
        return env["MASTER_ADDR"], port, "openmpi"

    if "PHILLY_CONTAINER_IP" in env:  # utils_MPIAdapter.py:43-54
        pair = (
            (env["PHILLY_CONTAINER_IP"], env.get("PHILLY_CONTAINER_PORT_RANGE_START", port))
            if rank == 0 else None
        )
        addr, port = _mpi_bcast(pair, rank) if size > 1 else pair
        return addr, port, "openmpi/philly"

    if "AMLK8S_NUM_WORKER" in env or "AZ_CMK8S_JOB_WORK_DIR" in env:
        # AMLK8S (ITP), utils_MPIAdapter.py:55-73: worker-0 IP from the
        # per-node init.env file; single-node fallback otherwise
        import re

        path = env.get("CLIP_EVENT_ITP_ENV_FILE", ITP_ENV_FILE)
        match = None
        if os.path.exists(path):
            with open(path) as fh:
                match = re.match(r"[\s\S]*export[\s]*DLTS_SD_worker0_IP=([0-9.]+)[\s|s]*", fh.read())
        if match:
            return match.group(1), port, "openmpi/itp"
        if size != local_size:
            raise RuntimeError(
                f"AMLK8S (ITP) multi-node job but no worker-0 IP in {path} "
                "(reference asserts the same, utils_MPIAdapter.py:69-71)"
            )
        return "127.0.0.1", port, "openmpi/itp-single-node"

    if "AZ_BATCH_MASTER_NODE" in env:  # multi-node AML, :74-79
        return env["AZ_BATCH_MASTER_NODE"].split(":")[0], port, "openmpi/aml"

    if size == local_size:  # single node, :80-84
        return "127.0.0.1", port, "openmpi/single-node"

    addr = _first_host(env.get("OMPI_MCA_orte_default_hostfile"))
    if addr:
        return addr, port, "openmpi"

    # generic multi-node MPI: rank 0 resolves its own address, :85-98
    if rank == 0:
        out = subprocess.run(["hostname", "-I"], capture_output=True, text=True, timeout=10).stdout
        pair = (out.split()[0], port) if out.split() else (None, port)
    else:
        pair = None
    addr, port = _mpi_bcast(pair, rank)
    return addr, port, "openmpi/multi-node"


def _first_host(hostfile: Optional[str]) -> Optional[str]:
    if not hostfile or not os.path.exists(hostfile):
        return None
    with open(hostfile) as fh:
        for line in fh:
            line = line.split()[0].strip() if line.split() else ""
            if line:
                return line
    return None


def initialize_from_cluster(backend: str, spec: Optional[ClusterSpec] = None) -> ClusterSpec:
    """Detect the launch (or take `spec`) and `init_process_group(backend)`
    for a torchrun launch (any world) or a multi-process OpenMPI / SLURM
    one. A multi-process launch without a resolvable rank-0 address
    raises: it would otherwise train one independent copy a process."""
    import torch.distributed as dist

    spec = detect_cluster() if spec is None else spec
    log.info("cluster: %s", spec)
    if spec.source == "torchrun" or spec.is_distributed:
        if not spec.coordinator_address:
            raise RuntimeError(
                f"{spec.source}: {spec.num_processes} processes but no rank-0 address; "
                "export MASTER_ADDR/MASTER_PORT from the launcher"
            )
        dist.init_process_group(
            backend, init_method=f"tcp://{spec.coordinator_address}",
            world_size=spec.num_processes, rank=spec.process_id,
        )
    return spec
