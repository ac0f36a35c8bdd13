"""The data group and the meshes over ``torch.distributed`` (parity: the
JAX package's ``parallel/mesh.py``: `get_mesh`, `default_mesh`,
`set_default_mesh`, `mesh_axis_sizes`; the ``Mesh(devices.reshape(dp,
pp, tp), ("dp", "pp", "tp"))`` of ``parallel/transformer.py``'s
``SPMDTrainer``, `SPMDMesh` here; and ``compiler.py``'s
``devices.reshape(dp, pp, tp)`` with axes ("dp", "pp", "tp"),
`fluid_mesh`).

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

import itertools
import os
import socket

import torch
import torch.distributed as dist

from ..core.place import default_device

__all__ = ["AXES", "AxisGroup", "DataGroup", "Mesh", "MeshGroupOrderError",
           "SPMDMesh", "data_group", "default_mesh", "destroy_data_group",
           "env_contract", "fluid_mesh", "get_mesh", "group_plan",
           "init_data_group", "mesh_axis_sizes", "mesh_unions",
           "set_default_mesh"]

_default_mesh = [None]
_group = [None]
_fluid_meshes = {}


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
    """The JAX Mesh's face over the data group, for the Fluid data-parallel
    path (``ParallelExecutor``, ``CompiledProgram``, the fleet):
    `axis_names` ("dp",), `shape` {"dp": world}, `devices` (this rank's),
    `group`. The SPMD trainer's (dp, pp, tp) mesh is `SPMDMesh`; the Fluid
    step's (dp, pp, tp) mesh, `fluid_mesh`."""

    def __init__(self, group, axis_names=("dp",)):
        if tuple(axis_names) != ("dp",):
            raise NotImplementedError(
                "mesh axes %r: the Fluid data-parallel mesh has the data "
                "axis only; the Fluid step's (dp, pp, tp) mesh is "
                "parallel.mesh.fluid_mesh, the SPMD trainer's "
                "parallel.mesh.SPMDMesh" % (tuple(axis_names),))
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
    for m in _fluid_meshes.values():
        m.close()
    _fluid_meshes.clear()
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


# ---------------------------------------------------------------------------
# the SPMD trainer's (dp, pp, tp) mesh
# ---------------------------------------------------------------------------

AXES = ("dp", "pp", "tp")


class MeshGroupOrderError(RuntimeError):
    """The ranks would create the mesh's process groups in different
    orders. ``new_group`` is collective over every rank, so NCCL would
    hang; the mesh compares the plans first and raises this instead."""


class AxisGroup(DataGroup):
    """This rank's line of one union of mesh axes: a `DataGroup` (`pg`
    None for a line of one rank) plus `ranks`, the line's global ranks in
    axis order (`rank` is this rank's index among them)."""

    def __init__(self, pg, ranks, rank, device, backend):
        super().__init__(pg, ranks.index(rank), len(ranks), device, backend)
        self.ranks = tuple(ranks)

    def __repr__(self):
        return "AxisGroup(ranks=%r, rank=%d)" % (self.ranks, self.rank)


def mesh_unions(unions=()):
    """The unions of mesh axes a mesh builds groups for, checked and in
    one fixed order: each of `unions` (an axis name or a tuple of them)
    as a tuple in AXES order, plus the single axes and all three (the
    loss's sum), sorted by size then by AXES order, each once."""
    out = {(a,) for a in AXES} | {AXES}
    for u in unions:
        u = (u,) if isinstance(u, str) else tuple(u)
        key = tuple(a for a in AXES if a in u)
        if not u or len(key) != len(u) or len(set(u)) != len(u):
            raise ValueError("mesh axes %r: expected distinct names from %r"
                             % (u, AXES))
        out.add(key)
    return sorted(out, key=lambda u: (len(u), [AXES.index(a) for a in u]))


def group_plan(shape, unions):
    """The process groups of a (dp, pp, tp) mesh in the one order every
    rank creates them: for each union of axes of `unions` (a
    `mesh_unions` list), each line of it (the ranks whose other
    coordinates agree, sorted) as (axes, ranks). A rank's coordinates
    are the JAX mesh's ``reshape(dp, pp, tp)``: rank = (d·pp + p)·tp +
    t."""
    coords = list(itertools.product(*(range(n) for n in shape)))
    plan = []
    for axes in unions:
        lines = {}
        for rank, c in enumerate(coords):
            key = tuple(x for a, x in zip(AXES, c) if a not in axes)
            lines.setdefault(key, []).append(rank)
        plan += [(axes, tuple(lines[key])) for key in sorted(lines)]
    return plan


class SPMDMesh:
    """The (dp, pp, tp) mesh of ``SPMDTrainer``: one process a rank.

    `mesh_shape` (dp, pp, tp); `shape` the same as a dict (the JAX
    Mesh's, so `mesh_axis_sizes` reads it); `rank`,
    `world`, `device`, `backend`; `axis_index(name)` and
    `axis_size(name)`; `group(axes)` this rank's `AxisGroup` of one axis
    or of a union of axes (a str or a tuple, in any order) among
    `unions`: the single axes, all three, and the unions given
    (`mesh_unions`; the trainer's are the axes its grads are summed
    over).

    A mesh of more than one rank runs on the data group
    (`init_data_group`: the fleet's env contract, NCCL on the card, gloo
    on the CPU) and needs the world size to equal dp·pp·tp. Every rank
    creates every group of `group_plan` over `unions`, in its order
    (``new_group`` is
    collective), after checking that all ranks hold the same plan
    (`MeshGroupOrderError` if not), then runs one all-reduce on each
    group it is in, in the same order: NCCL's communicators come up here
    rather than inside a step, and the pipeline's first send/receive is
    not a group's first call. A mesh of one rank needs no process group:
    every axis is a line of one, each collective the identity (still
    counted)."""

    def __init__(self, shape, device=None, unions=()):
        shape = tuple(int(n) for n in shape)
        self.unions = mesh_unions(unions)
        if len(shape) != 3 or min(shape) < 1:
            raise ValueError("mesh shape %r: expected (dp, pp, tp), each "
                             ">= 1" % (shape,))
        self.mesh_shape = shape
        self.shape = dict(zip(AXES, shape))
        n = shape[0] * shape[1] * shape[2]
        self._owned = []
        if n == 1:
            rank = dist.get_rank() if dist.is_initialized() else 0
            self.rank, self.world = 0, 1
            self.device = _rank_device(device, rank)
            self.backend = None
            self._coords = (0, 0, 0)
            self._groups = {axes: AxisGroup(None, ranks, 0, self.device,
                                            None)
                            for axes, ranks in group_plan(shape,
                                                          self.unions)}
            return
        g = init_data_group(device)
        if g.world != n:
            raise ValueError(
                "the world size (%d) must equal dp·pp·tp = %d for mesh %r"
                % (g.world, n, shape))
        self.rank, self.world = g.rank, g.world
        self.device, self.backend = g.device, g.backend
        self._coords = tuple(itertools.product(
            *(range(k) for k in shape)))[self.rank]
        plan = group_plan(shape, self.unions)
        self._check_plan(g, plan)
        # one process group a distinct line (a union whose other axes
        # have size 1 has the lines of a smaller one)
        pgs = {tuple(range(g.world)): g.pg}
        self._groups = {}
        for axes, ranks in plan:
            if len(ranks) > 1 and ranks not in pgs:
                pgs[ranks] = dist.new_group(list(ranks))
                self._owned.append(pgs[ranks])
            if self.rank in ranks:
                self._groups[axes] = AxisGroup(pgs.get(ranks), ranks,
                                               self.rank, self.device,
                                               self.backend)
        one = torch.ones(1, device=self.device)
        for ranks, pg in pgs.items():
            if self.rank in ranks:
                dist.all_reduce(one, group=pg)

    def _check_plan(self, g, plan):
        plans = [None] * g.world
        dist.all_gather_object(plans, plan, group=g.pg)
        bad = [r for r, p in enumerate(plans) if p != plans[0]]
        if bad:
            raise MeshGroupOrderError(
                "ranks %r would create the process groups of mesh %r in "
                "another order than rank 0 (new_group is collective: "
                "every rank must create every group in one order)"
                % (bad, self.mesh_shape))

    def axis_index(self, name):
        return self._coords[AXES.index(name)]

    def axis_size(self, name):
        return self.shape[name]

    def group(self, axes):
        if isinstance(axes, str):
            axes = (axes,)
        key = tuple(a for a in AXES if a in axes)
        if key not in self.unions:
            raise ValueError("mesh axes %r: this mesh has groups over %r "
                             "only" % (axes, self.unions))
        return self._groups[key]

    def close(self):
        """Take down the groups this mesh created (not the data group)."""
        for pg in self._owned:
            dist.destroy_process_group(pg)
        self._owned = []

    def __repr__(self):
        return "SPMDMesh(dp=%d, pp=%d, tp=%d, rank=%d, device=%s)" % (
            self.mesh_shape + (self.rank, self.device))


def fluid_mesh(tp, device=None, pp=1):
    """The Fluid step's (dp, pp, tp) mesh under ``tensor_parallel_degree
    = tp`` and ``pipeline_stages = pp``: an `SPMDMesh` of shape (world //
    (pp·tp), pp, tp) over the data group, so rank = (d·pp + p)·tp + t as
    in the JAX package's ``devices.reshape(dp, pp, tp)`` with axes ("dp",
    "pp", "tp") (``compiler.py``'s ``_get_mesh``), and its groups come up
    in `group_plan`'s one order. Its "dp" line carries the batch's
    collectives, its "tp" line the tensor-parallel region's, its "pp"
    line the pipeline's sends and receives and, with pp > 1, its ("dp",
    "pp") union the pipelined step's grad sums. One mesh a shape a
    process, brought up on first use (every rank of the world must ask
    for it: ``new_group`` is collective). A world that pp·tp does not
    divide raises as the JAX package's does."""
    g = init_data_group(device)
    degrees = [(k, d) for k, d in (("pipeline_stages", pp),
                                   ("tensor_parallel_degree", tp))
               if d > 1]
    if tp < 1 or pp < 1 or g.world % (pp * tp):
        raise ValueError(
            "%s = %s does not divide the %d-device mesh" % (
                " * ".join(k for k, _ in degrees),
                " * ".join(str(d) for _, d in degrees), g.world))
    shape = (g.world // (pp * tp), pp, tp)
    m = _fluid_meshes.get(shape)
    if m is None:
        unions = [("dp", "pp")] if pp > 1 else ()
        m = _fluid_meshes[shape] = SPMDMesh(shape, g.device, unions)
    return m
