"""The data group over ``torch.distributed`` (parity: the JAX package's
``parallel/mesh.py``: `get_mesh`, `default_mesh`, `set_default_mesh`,
`mesh_axis_sizes`).

The JAX package lays every device of its one process on a ``dp`` mesh
axis. The port runs one process a rank: rank, world size and the
rendezvous come from the fleet's env contract, ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM`` and ``PADDLE_TRAINER_ENDPOINTS`` (the first
endpoint, ``host:port``, is the rendezvous; ``PADDLE_CURRENT_ENDPOINT``
names this rank's own), or ``PADDLE_COORDINATOR_ADDR`` when it is set.
One process with none of them set is a world of one on a free local
port. A process group that is already up (``torchrun``) is used as it
is.

The backend follows the device: ``nccl`` for a CUDA device, each rank on
``cuda:<rank % visible cards>`` unless the caller names its card, and
``gloo`` only when the caller asks for the CPU. Without CUDA, a caller
that does not ask for the CPU gets an error, not the CPU.
"""

import os
import socket

import torch
import torch.distributed as dist

from ..core.place import default_device

__all__ = ["DataGroup", "Mesh", "data_group", "default_mesh",
           "destroy_data_group", "env_contract", "get_mesh",
           "init_data_group", "mesh_axis_sizes", "set_default_mesh"]

_default_mesh = [None]
_group = [None]


class DataGroup:
    """The ranks of the data axis: `pg` the process group, `rank`,
    `world`, `device` this rank's device and `backend`."""

    def __init__(self, pg, rank, world, device, backend, owned=False):
        self.pg = pg
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        # brought up here (not found up): destroy_data_group takes it down
        self.owned = owned

    def __repr__(self):
        return "DataGroup(rank=%d, world=%d, device=%s, backend=%s)" % (
            self.rank, self.world, self.device, self.backend)


class Mesh:
    """The JAX Mesh's face over the data group: `axis_names` ("dp",),
    `shape` {"dp": world}, `devices` (this rank's), `group`."""

    def __init__(self, group, axis_names=("dp",)):
        if tuple(axis_names) != ("dp",):
            raise NotImplementedError(
                "mesh axes %r: the port's mesh has the data axis only; tp, "
                "pp and sp wait for the rest of ROADMAP.md Queue 1 item 9"
                % (tuple(axis_names),))
        self.group = group
        self.axis_names = ("dp",)
        self.shape = {"dp": group.world}
        self.devices = [group.device]


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env_contract():
    """(rank, world, rendezvous "host:port" or None) from the fleet's
    env contract."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    addr = os.environ.get("PADDLE_COORDINATOR_ADDR") or None
    if addr is None:
        eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                         "").split(",") if e]
        if eps:
            addr = eps[0]
    if not 0 <= rank < world:
        raise ValueError("PADDLE_TRAINER_ID=%d is outside a world of "
                         "PADDLE_TRAINERS_NUM=%d" % (rank, world))
    return rank, world, addr


def _rank_device(device, rank):
    """This rank's device: the CPU when asked for, else a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        default_device()  # raises without CUDA
        return torch.device(device)
    default_device()
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_data_group(device=None):
    """Bring up (once a process) and return the `DataGroup`. `device`
    "cpu" selects gloo; None or a CUDA device selects NCCL on that card
    (None: ``cuda:<rank % visible cards>``)."""
    g = _group[0]
    if g is not None:
        if device is not None and torch.device(device).type \
                != g.device.type:
            raise RuntimeError(
                "the data group runs on %s over %s; a step on %s cannot "
                "join it" % (g.device, g.backend, device))
        return g
    owned = not dist.is_initialized()
    if not owned:
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
        dev = _rank_device(device, rank)
    else:
        rank, world, addr = env_contract()
        dev = _rank_device(device, rank)
        backend = "gloo" if dev.type == "cpu" else "nccl"
        if addr is None:
            if world > 1:
                raise RuntimeError(
                    "PADDLE_TRAINERS_NUM=%d but no rendezvous: set "
                    "PADDLE_TRAINER_ENDPOINTS (the first endpoint is the "
                    "rendezvous) or PADDLE_COORDINATOR_ADDR" % world)
            addr = "127.0.0.1:%d" % _free_port()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="tcp://" + addr,
                                world_size=world, rank=rank)
    if (dev.type == "cpu") != (backend == "gloo"):
        raise RuntimeError(
            "the process group's backend is %s, which does not serve %s "
            "(nccl for a card, gloo for the CPU)" % (backend, dev))
    g = _group[0] = DataGroup(dist.group.WORLD, rank, world, dev, backend,
                              owned)
    return g


def data_group():
    """The group brought up by `init_data_group`, or None."""
    return _group[0]


def destroy_data_group():
    """Take down the process group `init_data_group` brought up (a
    group it found up is left to its owner)."""
    g = _group[0]
    _group[0] = None
    _default_mesh[0] = None
    if g is not None and g.owned and dist.is_initialized():
        dist.destroy_process_group()


def get_mesh(axis_names=("dp",), shape=None, devices=None):
    """The data mesh over the group (brought up for `devices[0]` when it
    is not up yet). A `shape` other than (world,) raises: the port's
    mesh has the data axis only."""
    g = init_data_group(devices[0] if devices else None)
    if shape is not None and tuple(shape) != (g.world,):
        raise NotImplementedError(
            "mesh shape %r: the port's mesh is the data axis of all %d "
            "ranks" % (tuple(shape), g.world))
    return Mesh(g, axis_names)


def default_mesh():
    if _default_mesh[0] is None:
        _default_mesh[0] = get_mesh()
    return _default_mesh[0]


def set_default_mesh(mesh):
    _default_mesh[0] = mesh


def mesh_axis_sizes(mesh):
    return dict(mesh.shape)
