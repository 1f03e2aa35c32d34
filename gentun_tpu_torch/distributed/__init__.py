"""Distribution layer: the master↔worker control plane over DCN.

The rebuild's replacement for the reference's RabbitMQ transport
(``gentun/server.py`` + ``gentun/client.py`` [PUB][BASELINE]; SURVEY.md §1
L2, §5 "Distributed communication backend"): an embedded asyncio TCP/JSON
broker with AMQP-equivalent at-least-once + competing-consumer semantics.
Only genes, hyperparameters, and fitness scalars cross the wire; data and
training stay inside each worker, on its CUDA device.  The wire is
byte-compatible with the JAX package's, so either package's master can be
served by either package's workers; fitness values keep their own
protocol stamps (``utils.fitness_store.FITNESS_PROTOCOL``).
"""

from .broker import GatherTimeout, JobBroker, JobFailed
from .client import GentunClient
from .faults import FaultInjector, FaultPlan, FaultSpec, MasterKilled
from .fitness_service import FitnessService, FitnessServiceClient, ServiceBackedCache
from .protocol import AuthError
from .server import DistributedGridPopulation, DistributedPopulation
from .journal import (
    JOURNAL_SCHEMA,
    DispatchJournal,
    JournalCorruptError,
    JournalError,
    JournalSchemaError,
    replay_file,
)
from .sessions import (
    DEFAULT_SESSION,
    AdmissionRejected,
    FairShareScheduler,
    SearchSession,
    SessionClient,
    UnknownSessionError,
    genome_key,
)

__all__ = [
    "JobBroker",
    "JobFailed",
    "GatherTimeout",
    "GentunClient",
    "AuthError",
    "DistributedPopulation",
    "DistributedGridPopulation",
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "MasterKilled",
    "FitnessService",
    "FitnessServiceClient",
    "ServiceBackedCache",
    "DEFAULT_SESSION",
    "SearchSession",
    "SessionClient",
    "FairShareScheduler",
    "UnknownSessionError",
    "AdmissionRejected",
    "JOURNAL_SCHEMA",
    "DispatchJournal",
    "JournalError",
    "JournalCorruptError",
    "JournalSchemaError",
    "replay_file",
    "genome_key",
]
