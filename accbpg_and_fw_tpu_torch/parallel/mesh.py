"""Process groups, device meshes and problem sharding on
``torch.distributed`` (counterpart of
``accbpg_and_fw_tpu/parallel/mesh.py``).

The sharding layout is the JAX package's:

* D-optimal design: H is m-by-n with n >> m.  H shards column-wise
  (``Shard(1)``), the iterate x and every length-n vector shard
  (``Shard(0)``); the Gram matrix H diag(x) H^T and every scalar end up
  replicated.  The Gram contraction sums over the mesh, the drivers' host
  reads gather their scalars (``_scalar.read``), and the FW engine's
  arg-reductions run over the whole vector.
* Regressions (Poisson/KL/logistic/SVM): A is m-by-n with m samples.  A
  and b shard row-wise, x replicates; the gradient A^T r sums over the
  samples.

As under GSPMD in JAX, placing the arrays is all that is needed: the
arrays become ``torch.distributed.tensor.DTensor``s and the same driver
code runs on them, each operation propagating the placements.  A DTensor
never reaches a CUDA kernel of the port: the kernels take plain tensors,
so ``u_mode="auto"`` takes the exact engine for a sharded design and the
explicit kernel modes (``u_mode="pallas"``/``"pallas_lazy"``,
``BurgEntropySimplex(use_pallas=True)``) raise ``ValueError``, as does
``dopt_fw_batch`` for a sharded batch (it solves on one device).

One rank drives one device.  JAX's mesh of many devices in one process
has no counterpart here: a mesh of N devices is N processes, each started
with ``distributed_init`` (or ``torch.distributed.init_process_group``).
Only the ``H`` field of the JAX package's column-indexed D-opt fields
exists here: the Mixed and DS oracles' digit and double-single planes are
FP64 ``H`` in the port.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .._device import as_f64


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None):
    """Join this process to a group of ``num_processes`` ranks that meet
    at ``coordinator_address`` (``"host:port"``, or a ``tcp://`` URL),
    as rank ``process_id``.  ``backend``: NCCL where the process has a
    CUDA card (each rank then takes card ``process_id % count``), gloo on
    the CPU.  No-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    address = str(coordinator_address)
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id))


def data_mesh(devices=None, axis_name: str = "data"):
    """A 1-D ``DeviceMesh`` with one named axis over every rank of the
    process group, one device per rank.  ``devices``: the device type
    (``"cuda"`` or ``"cpu"``); None takes CUDA where the process has a
    card.  JAX's one-process mesh over a list of devices has no
    counterpart: start one process per device instead."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is None:
        devices = "cuda" if torch.cuda.is_available() else "cpu"
    device_type = torch.device(devices).type
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _place(a, mesh, *placements):
    """``a`` as a float64 DTensor on ``mesh`` with ``placements``."""
    from torch.distributed.tensor import distribute_tensor

    a = as_f64(a, torch.device(mesh.device_type))
    return distribute_tensor(a, mesh, list(placements))


def _ndev(mesh, axis_name):
    return mesh.shape[mesh.mesh_dim_names.index(axis_name)]


def _pad_cols(H, x0, ndev):
    """Zero-pad design columns (and x entries) to a device-count multiple.

    Exactness: a zero column v = 0 with weight x = 0 contributes nothing to
    V diag(x) V^T, has gradient/w entry exactly 0, is never selected by the
    FW argmax (max w >= m >= 1 > 0) nor by the away argmin (masked on
    x > 1e-8), and x = 0 is a fixed point of every update (x * (1 -+ t)
    keeps 0; the Burg div_prox_map maps y = 0 to g + L/0 = inf and
    1/(inf + c) = 0).  So the padded problem's trajectory restricted to the
    first n coordinates is the unpadded trajectory."""
    n = H.shape[1]
    rem = (-n) % ndev
    if rem:
        H = F.pad(H, (0, rem))
        x0 = F.pad(x0, (0, rem))
    return H, x0


def _dense_pair(H, x0, mesh):
    dev = torch.device(mesh.device_type)
    return as_f64(H, dev), as_f64(x0, dev)


def shard_dopt_problem(f, x0, mesh, axis_name: str = "data",
                       pad: bool = True):
    """Place a D-opt problem on a mesh: the design's columns shard over
    ``axis_name`` and so does x0; returns ``(f_sharded, x0_sharded)``.

    When n is not a multiple of the mesh size and ``pad=True`` (default),
    the design is zero-padded to the next multiple, exactly neutral for
    the D-opt solvers (see ``_pad_cols``); the returned arrays have the
    padded length and the padding x entries stay 0 (slice them off with
    ``x[:n]``).  The zero-pad argument does not extend to ``h.prox_map``
    on arbitrary g (ABDA's dual averaging), so the returned oracle carries
    ``n_valid``: padded gradient entries report +1e30, which every prox
    maps to ~0 mass.  An oracle without an ``n_valid`` field gets a clear
    error when padding would be required."""
    ndev = _ndev(mesh, axis_name)
    design = getattr(f, "H", None)
    if design is None:
        raise TypeError(
            f"{type(f).__name__} carries neither an H nor a Vh design "
            "field; shard_dopt_problem supports DOptimalObj, "
            "DOptimalObjMixed and DOptimalObjDS.")
    H, x0 = _dense_pair(design, x0, mesh)
    n = H.shape[-1]
    out = copy.copy(f)
    if pad and n % ndev != 0:
        if not hasattr(f, "n_valid"):
            raise ValueError(
                f"{type(f).__name__} has no n_valid field, so it cannot "
                f"be padded from n={n} to a multiple of {ndev} safely "
                "(ABDA-style prox on duals would hand padded coordinates "
                "mass, and Mixed/DS digit planes would need re-splitting)."
                " Pass pad=False with a mesh-divisible n, or use "
                "DOptimalObj.")
        H, x0 = _pad_cols(H, x0, ndev)
        out.n_valid = n
    from torch.distributed.tensor import Shard

    out.H = _place(H, mesh, Shard(1))
    out._pads = None
    return out, _place(x0, mesh, Shard(0))


def shard_dopt_design(V, x0, mesh, axis_name: str = "data",
                      pad: bool = True):
    """Column-shard a raw design matrix and initial point for the
    ``D_opt_FW`` / ``D_opt_FW_away`` solvers, zero-padding n to a mesh-size
    multiple (exactly neutral; see ``_pad_cols``).  Returns
    ``(V_sharded, x0_sharded)``."""
    from torch.distributed.tensor import Shard

    V, x0 = _dense_pair(V, x0, mesh)
    if pad:
        V, x0 = _pad_cols(V, x0, _ndev(mesh, axis_name))
    return _place(V, mesh, Shard(1)), _place(x0, mesh, Shard(0))


def shard_symnmf_problem(f, X0, mesh, axis_name: str = "data"):
    """Place a SymNMF problem (``FrobeniusSymLoss``) on a mesh: the n x n
    similarity matrix M and the n x r factor X shard row-wise over
    ``axis_name`` (M is the memory wall: n^2 entries)."""
    from torch.distributed.tensor import Shard

    out = copy.copy(f)
    out.M = _place(f.M, mesh, Shard(0))
    return out, _place(X0, mesh, Shard(0))


def shard_regression_problem(f, x0, mesh, axis_name: str = "data"):
    """Place a row-major regression oracle (``PoissonRegression``,
    ``KLdivRegression``, ``LogisticRegression``, ``SVM_fun``: fields A or
    X and b or y) on a mesh: samples shard over ``axis_name``, the
    iterate replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = copy.copy(f)
    for field in ("A", "X", "b", "y"):
        v = getattr(f, field, None)
        if v is not None:
            setattr(out, field, _place(v, mesh, Shard(0)))
    return out, _place(x0, mesh, Replicate())
