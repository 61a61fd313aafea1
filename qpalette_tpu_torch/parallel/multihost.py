"""Several hosts: process-group set-up and a (dp, tp) device mesh.

Counterpart of ``qpalette_tpu/parallel/multihost.py``.  One process a
device joins one ``torch.distributed`` job (``init_distributed``); the
mesh's outer axis ``dp`` splits the batch (each dp group holds a whole
copy of the weights), and its inner axis ``tp`` splits the weights as
parallel/tp.py (scheme "row") or parallel/sharding.py (scheme
"column") does, inside one host, so that the tensor-parallel collectives
of every layer stay on the host's own links (``dcn_mesh`` asserts it).
Only the batch crosses hosts.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from qpalette_tpu_torch.models import llama
from qpalette_tpu_torch.parallel import sharding
from qpalette_tpu_torch.parallel import tp as tp_mod

SCHEMES = ("row", "column")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join this process into a multi-process job:
    ``init_process_group(backend, init_method="tcp://<coordinator>",
    world_size, rank)``.  The arguments default from QPT_COORDINATOR
    (host:port), QPT_NUM_PROCESSES and QPT_PROCESS_ID; the backend from
    the caller, else nccl where CUDA is available and gloo elsewhere."""
    addr = coordinator_address or os.environ.get("QPT_COORDINATOR")
    nproc = num_processes if num_processes is not None else \
        os.environ.get("QPT_NUM_PROCESSES")
    pid = process_id if process_id is not None else \
        os.environ.get("QPT_PROCESS_ID")
    if addr is None or nproc is None or pid is None:
        raise ValueError("init_distributed needs the coordinator address, "
                         "the number of processes and this process's id "
                         "(arguments or QPT_COORDINATOR / QPT_NUM_PROCESSES "
                         "/ QPT_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(nproc), rank=int(pid))


def dcn_mesh(tp: int, dp: Optional[int] = None,
             device_type: Optional[str] = None,
             local_processes: Optional[int] = None) -> DeviceMesh:
    """The ("dp", "tp") mesh of the job's ranks, process-major: rank r is
    (r // tp, r % tp).  device_type defaults to the job's backend: cuda
    under nccl (a card a rank), cpu under gloo, whose groups carry CPU
    and CUDA tensors alike (so ranks may share one card).
    local_processes (default LOCAL_WORLD_SIZE, else the world size): the
    ranks a host holds, which tp must divide into, so that a tp group
    never straddles two hosts."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp={dp} x tp={tp} != {n} processes")
    local = local_processes or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if tp > local or local % tp:
        raise ValueError(f"tp={tp} must fit within one host ({local} "
                         f"processes a host) so that the tensor-parallel "
                         f"all_reduce stays on the host's links")
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def shard_model_dcn(params: dict, spec, mesh: DeviceMesh,
                    scheme: str = "row"):
    """This rank's (local spec, params) on a (dp, tp) mesh: the weights
    replicated across dp and split across tp as the scheme places them,
    "row" parallel/tp.py and "column" parallel/sharding.py (every dp group
    the same slices)."""
    lspec = _local_spec(spec, mesh, scheme)
    if scheme == "column":
        return lspec, sharding.shard_params(params, spec, mesh)
    tpn = mesh.size(mesh.mesh_dim_names.index("tp"))
    return lspec, tp_mod.shard_params(params, spec, tpn,
                                      mesh.get_local_rank("tp"))


def dp_batch_spec(tokens: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a global batch (B, T): the batch split over the
    data-parallel axis (B a multiple of dp)."""
    dpn = mesh.size(mesh.mesh_dim_names.index("dp"))
    b = tokens.shape[0] // dpn
    r = mesh.get_local_rank("dp")
    return tokens[r * b:(r + 1) * b]


def dcn_forward_fn(spec, mesh: DeviceMesh, with_cache: bool = False,
                   scheme: str = "row"):
    """The (dp, tp) forward of one rank: fn(local_params, tokens) with the
    whole batch on every rank -> the logits of this rank's rows
    (dp_batch_spec); with_cache: fn(local_params, tokens, kv_caches,
    cache_pos) -> (logits, caches), the caches this rank's rows and kv
    heads.  Weights as shard_model_dcn places them under the scheme."""
    lspec = _local_spec(spec, mesh, scheme)

    if not with_cache:
        def fwd(params, tokens):
            return llama.forward(lspec, params, dp_batch_spec(tokens, mesh))
        return fwd

    def fwd_cache(params, tokens, kv_caches, cache_pos):
        return llama.forward(lspec, params, dp_batch_spec(tokens, mesh),
                             kv_caches=kv_caches, cache_pos=cache_pos)
    return fwd_cache


def _local_spec(spec, mesh: DeviceMesh, scheme: str = "row"):
    """spec localized over the mesh's tp axis (its group) under the
    scheme, or spec."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {SCHEMES}")
    tpn = mesh.size(mesh.mesh_dim_names.index("tp"))
    if tpn == 1:
        return spec
    if scheme == "column":
        return sharding.localize_spec(spec, tpn, mesh.get_group("tp"))
    return tp_mod.localize_spec(spec, tpn, mesh.get_group("tp"))
