"""ParallelExecutor (parity: the JAX package's
``parallel/parallel_executor.py`` :17-57).

One process a rank: the program runs through
``CompiledProgram.with_data_parallel`` on this rank's device
(``parallel/mesh.py``: ``cuda:<rank % visible cards>`` over NCCL, or the
CPU over gloo with ``use_cuda=False``), every rank fed the same global
batch. `device_count` is the world size.
"""

import copy

from .. import framework
from ..compiler import BuildStrategy, CompiledProgram, ExecutionStrategy

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None, amp=False):
        from ..executor import Executor
        from .mesh import init_data_group

        self._program = main_program or framework.default_main_program()
        if amp:
            # the amp_rewrite pass for this executor's step; a shared
            # BuildStrategy is copied, so other executors keep theirs
            build_strategy = copy.copy(build_strategy) \
                if build_strategy is not None else BuildStrategy()
            build_strategy.amp = True
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name,
            build_strategy=build_strategy or BuildStrategy(),
            exec_strategy=exec_strategy or ExecutionStrategy(),
            share_vars_from=share_vars_from and share_vars_from._compiled,
        )
        # a test program's executor reads the training one's variables
        if scope is None and share_vars_from is not None:
            scope = share_vars_from._scope
        self._scope = scope
        self._group = init_data_group(None if use_cuda else "cpu")
        self._exe = Executor(self._group.device)

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._compiled._run(self._exe, feed, fetch_list, self._scope,
                                   return_numpy)

    @property
    def device(self):
        return self._group.device

    @property
    def device_count(self):
        return self._group.world

    def drop_local_exe_scopes(self):
        pass
