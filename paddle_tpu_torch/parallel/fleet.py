"""Fleet, the high-level distributed API in collective mode (parity: the
JAX package's ``parallel/fleet.py`` :1-184: `PaddleCloudRoleMaker`,
`UserDefinedRoleMaker`, `DistributedStrategy`, `Fleet`,
`CollectiveOptimizer`).

The role makers read the PADDLE_* env contract. `Fleet.init` brings up
the data group (``parallel/mesh.init_data_group``: NCCL on the card,
gloo for ``device="cpu"``) where the JAX package calls
``jax.distributed.initialize``; `barrier_worker` is ``dist.barrier``.
`CollectiveOptimizer.minimize` is the wrapped optimizer's and marks the
program (``_fleet_opt``); the program then trains data-parallel through
``CompiledProgram.with_data_parallel``. ``use_dgc=True`` raises (ROADMAP.md
Queue 1 item 9).
"""

import os

__all__ = ["Fleet", "fleet", "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
           "DistributedStrategy", "CollectiveOptimizer"]


class PaddleCloudRoleMaker:
    """Reads the PADDLE_* env contract: PADDLE_TRAINER_ID,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
    PADDLE_CURRENT_ENDPOINT, TRAINING_ROLE."""

    def __init__(self, is_collective=True):
        self._is_collective = is_collective
        self._id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self._num = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._endpoints = eps.split(",") if eps else []
        self._current = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self._role = os.environ.get("TRAINING_ROLE", "TRAINER")

    def worker_index(self):
        return self._id

    def worker_num(self):
        return self._num

    def is_worker(self):
        return self._role == "TRAINER"

    def is_server(self):
        return self._role == "PSERVER"

    def is_first_worker(self):
        return self._id == 0

    def get_trainer_endpoints(self):
        return self._endpoints


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, role="TRAINER", worker_num=1,
                 server_endpoints=None, is_collective=True):
        super().__init__(is_collective)
        self._id = current_id
        self._num = worker_num
        self._role = "TRAINER" if role in ("TRAINER", 1) else "PSERVER"
        self._endpoints = server_endpoints or []


class DistributedStrategy:
    """CollectiveOptimizer's strategy knobs."""

    def __init__(self):
        self.mode = "collective"
        self.nccl_comm_num = 1
        self.use_dgc = False
        self.dgc_sparsity = 0.99
        self.gradient_merge_k = 1
        self.amp = False


class Fleet:
    """The fleet facade."""

    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._group = None

    def init(self, role_maker=None, device=None):
        """Read the role and, where the env names a rendezvous
        (``PADDLE_TRAINER_ENDPOINTS`` or ``PADDLE_COORDINATOR_ADDR``) or
        the world is one process, bring up the data group (`device`
        "cpu": gloo; None or a card: NCCL). Otherwise the first
        data-parallel step brings it up."""
        from .mesh import env_contract, init_data_group

        self._role_maker = role_maker or PaddleCloudRoleMaker()
        _rank, world, addr = env_contract()
        if self._role_maker.is_worker() and (addr or world == 1):
            self._group = init_data_group(device)
        return self

    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        pass

    def stop_worker(self):
        pass

    def barrier_worker(self):
        import torch.distributed as dist

        if self._group is not None and self._group.world > 1:
            dist.barrier(group=self._group.pg)

    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_num(self):
        return self._role_maker.worker_num() if self._role_maker else 1

    def is_first_worker(self):
        return self.worker_index() == 0

    def is_worker(self):
        return self._role_maker.is_worker() if self._role_maker else True

    def is_server(self):
        return self._role_maker.is_server() if self._role_maker else False

    def server_num(self):
        return (self._role_maker.server_num()
                if self._role_maker and hasattr(self._role_maker,
                                                "server_num") else 0)

    def worker_endpoints(self):
        return (self._role_maker.get_trainer_endpoints()
                if self._role_maker else [])

    @property
    def device(self):
        """This worker's device in the data group."""
        return self._group.device if self._group is not None else None

    def distributed_optimizer(self, optimizer, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        return CollectiveOptimizer(optimizer, self._strategy, self)


class CollectiveOptimizer:
    """Wraps a Fluid optimizer for data-parallel training: minimize() is
    the wrapped optimizer's, and the program is marked for
    ``CompiledProgram.with_data_parallel``."""

    def __init__(self, optimizer, strategy, fleet_ref):
        if getattr(strategy, "use_dgc", False):
            raise NotImplementedError(
                "DistributedStrategy.use_dgc (deep gradient compression, "
                "parallel/dgc.py) is not ported (ROADMAP.md Queue 1 "
                "item 9)")
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet_ref

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        prog = loss.block.program
        prog._fleet_opt = {
            "mode": self._strategy.mode,
            "use_dgc": self._strategy.use_dgc,
            "gradient_merge_k": self._strategy.gradient_merge_k,
        }
        return result

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


fleet = Fleet()
