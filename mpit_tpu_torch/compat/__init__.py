"""``mpit_tpu_torch.compat`` — the ``mpiT``-flavored facade, ported from
:mod:`mpit_tpu.compat`.

Reference capability (SURVEY.md §3.1 C1/C3): the ``mpiT`` Lua module —
``Init``/``Initialized``/``Finalize``, ``Comm_rank``/``Comm_size``/
``Get_processor_name``, blocking ``Send``/``Recv``, nonblocking
``Isend``/``Irecv`` with request objects and ``Wait``/``Test``/``Probe``,
collectives ``Barrier``/``Bcast``/``Reduce``/``Allreduce``, and the datatype/
communicator constants (``mpiT.DOUBLE``, ``mpiT.FLOAT``, ``mpiT.INT``,
``mpiT.COMM_WORLD``, ``ANY_SOURCE``, ``ANY_TAG``).

Each MPI rank is a Python thread of one process
(:mod:`mpit_tpu_torch.compat.simulator`): messages flow through
tag-matched mailboxes, collectives rendezvous at barriers. Buffers are
torch tensors (numpy arrays are taken as tensors sharing their memory);
a message on the card moves through the CUDA copy kernel
(:mod:`mpit_tpu_torch.ops.kv_ship`) and never leaves the card.
:mod:`mpit_tpu_torch.compat.faults` declares seeded message and step
faults for a job.

Usage (the ``mpirun -n 4 th script.lua`` analogue)::

    from mpit_tpu_torch import compat as mpiT

    def main():
        mpiT.Init()
        rank = mpiT.Comm_rank(mpiT.COMM_WORLD)
        size = mpiT.Comm_size(mpiT.COMM_WORLD)
        ...
        mpiT.Finalize()

    mpiT.run(main, nranks=4)
"""

from mpit_tpu_torch.compat.faults import (  # noqa: F401
    FaultPlan,
    MessageRule,
    ReplicaKilled,
    Slowdown,
    StepAction,
)
from mpit_tpu_torch.compat.simulator import (  # noqa: F401
    ANY_SOURCE,
    AbortedError,
    ANY_TAG,
    CompatTimeoutError,
    bind_thread,
    BYTE,
    CHAR,
    COMM_WORLD,
    DOUBLE,
    FLOAT,
    INT,
    LONG,
    MAX,
    MIN,
    PROD,
    SUM,
    Allreduce,
    Barrier,
    Bcast,
    Comm,
    Comm_dup,
    Comm_rank,
    Comm_size,
    Finalize,
    Get_processor_name,
    Init,
    Initialized,
    Irecv,
    Isend,
    Probe,
    Recv,
    Reduce,
    Request,
    Send,
    Status,
    Test,
    Wait,
    Waitall,
    run,
)
