"""Driver entry points: one Gibbs iteration, and a run over a mesh.

Counterpart of the JAX package's root ``__graft_entry__.py``.
``entry()`` returns one Gibbs iteration of the flagship model (rats, NUTS
scheme) and its arguments.  ``dryrun_multichip(n)`` runs 3 iterations with
the chains sharded over an n-rank mesh; for even n >= 4 a (n/2, 2)
chains x data mesh also splits the rats over the data axis, as the JAX
package's entry names them (y, alpha and beta): each data rank holds its
15 rats' observations and its slices of alpha and beta, and the NUTS block
completes each density call and each sum over its coordinates over the
data group.  Both run on the card unless the caller names the CPU.

    python -m mamba_tpu_torch.graft_entry <init_method> <n> <rank> <device>

runs one rank of ``dryrun_multichip(n)`` (``dryrun_multichip`` starts the
ranks itself when no process group of n ranks is running).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rank of the dry run may take, and a collective may wait
RANK_TIMEOUT = 600


def entry(device="cuda"):
    """(fn, example_args): one full Gibbs iteration (NUTS block over the 62
    continuous rats parameters, then the conjugate Gibbs block on the
    variances) of one chain; ``fn(*args)`` returns new arguments."""
    from .model.compile import compile_model
    from .model.mcmc import _chain_inits
    from .models import rats
    from .ops import random as R

    model, inputs, inits = rats.build("nuts")
    cm = compile_model(model, inputs, inits[0], device=device)
    kernels = [s.build(cm) for s in model.samplers]

    def gibbs(keys, state, tunes):
        new_tunes = []
        for k, tune in zip(kernels, tunes):
            keys, sub = R.split(keys)
            state, t = k.step(sub, state, tune, False)
            new_tunes.append(t)
        return keys, state, tuple(new_tunes)

    keys = R.chain_keys(0, range(1), cm.device)
    state = _chain_inits(cm, inits[0], 1)
    tunes = tuple(k.init(keys, state) for k in kernels)
    return gibbs, (keys, state, tunes)


def _rank_device(device: str) -> torch.device:
    """The device of this rank: its own card under CUDA."""
    if device != "cuda":
        return torch.device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.cuda.set_device(rank % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def _dryrun_rank(n_devices: int, device: str) -> None:
    from .model.mcmc import mcmc
    from .models import rats
    from .parallel import make_mesh

    dev = _rank_device(device)
    mesh_type = "cuda" if dev.type == "cuda" else "cpu"
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = make_mesh({"chains": n_devices // 2, "data": 2}, mesh_type)
        site_specs = {"y": ("data",), "alpha": ("data",), "beta": ("data",)}
        chains = n_devices // 2
    else:
        mesh = make_mesh({"chains": n_devices}, mesh_type)
        site_specs = None
        chains = n_devices
    model, inputs, inits = rats.build("nuts")
    sim = mcmc(model, inputs, inits, 3, burnin=1, thin=1, chains=chains,
               mesh=mesh, site_specs=site_specs, verbose=False, device=dev)
    if sim.value.shape[2] != chains or not np.isfinite(sim.value).all():
        raise RuntimeError(f"dry run: draws of shape {sim.value.shape}, "
                           f"finite {np.isfinite(sim.value).all()}")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One engine run (3 iterations, 1 burnin) with the chains sharded over
    an ``n_devices``-rank mesh.  In a process group of ``n_devices`` ranks
    it runs this rank's part; with no group and one rank, in this process;
    otherwise it starts the ranks (gloo on the CPU, NCCL on one card each)
    and waits for them."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is running, not {n_devices}")
        _dryrun_rank(n_devices, device)
    elif n_devices == 1:
        _dryrun_rank(1, device)
    else:
        from .parallel.launch import python_module, run_ranks
        run_ranks(lambda r, init: python_module(
            "mamba_tpu_torch.graft_entry", init, n_devices, r, device),
            n_devices, timeout=RANK_TIMEOUT)


def _main(argv) -> int:
    from .parallel import distributed_init
    init, n, rank, device = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type=device, timeout=RANK_TIMEOUT)
    try:
        _dryrun_rank(n, device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
