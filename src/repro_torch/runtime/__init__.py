"""Async actor/learner FL runtime with staleness-aware compressed
aggregation (the port of ``repro.runtime``).

Import order matters: ``protocol`` is imported by
``repro_torch.fl.federated`` (the synchronous loop shares the message
codec), and ``actors`` imports ``repro_torch.fl.federated`` back for
cohort sampling; loading protocol first keeps the cycle one-directional
at package-init time.
"""
from repro_torch.runtime import protocol  # noqa: F401  (must precede actors)
from repro_torch.runtime.buffer import (  # noqa: F401
    BufferStats,
    RoundBuffer,
    combine_weights,
)
from repro_torch.runtime.chaos import (  # noqa: F401
    Fault,
    FaultPlan,
    LearnerKilled,
    parse_plan,
)
from repro_torch.runtime.messages import SHUTDOWN  # noqa: F401
from repro_torch.runtime.messages import (  # noqa: F401
    ClientUpdate,
    Heartbeat,
    JoinAck,
    JoinRequest,
    RoundAnnounce,
)
from repro_torch.runtime.monitor import Monitor, RoundRecord  # noqa: F401
from repro_torch.runtime.protocol import RoundProtocol  # noqa: F401
from repro_torch.runtime.transport import (  # noqa: F401
    ClientEndpoint,
    LearnerEndpoint,
    ProcessTransport,
    ThreadTransport,
    TransportError,
    make_transport,
)

from repro_torch.runtime.actors import (  # noqa: F401,E402
    ClientSpec,
    Learner,
    run_client,
)
from repro_torch.runtime.runtime import (  # noqa: F401,E402
    AsyncFederatedRuntime,
    RuntimeConfig,
    analytic_bits_per_coord,
)
from repro_torch.runtime.workloads import (  # noqa: F401,E402
    ModelGradWorkload,
    QuadraticWorkload,
)

__all__ = [
    "protocol",
    "RoundProtocol",
    "RoundAnnounce",
    "ClientUpdate",
    "Heartbeat",
    "JoinRequest",
    "JoinAck",
    "SHUTDOWN",
    "RoundBuffer",
    "BufferStats",
    "combine_weights",
    "Fault",
    "FaultPlan",
    "LearnerKilled",
    "parse_plan",
    "Monitor",
    "RoundRecord",
    "TransportError",
    "ClientEndpoint",
    "LearnerEndpoint",
    "ThreadTransport",
    "ProcessTransport",
    "make_transport",
    "ClientSpec",
    "run_client",
    "Learner",
    "RuntimeConfig",
    "AsyncFederatedRuntime",
    "analytic_bits_per_coord",
    "QuadraticWorkload",
    "ModelGradWorkload",
]
