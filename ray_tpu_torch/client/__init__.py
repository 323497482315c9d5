"""ray_tpu_torch.client — the remote-driver ("rt://") stack.

Role-equivalent to the reference's Ray Client (ref:
python/ray/util/client/ARCHITECTURE.md + util/client/server/): a laptop
driver connects to the head over ONE connection with
``init(address="rt://host:port")`` and uses the full API surface —
tasks, actors, put/get/wait, named actors, kill/cancel — without being
routable from the cluster.  Topology mirrors the reference's
SpecificServer-per-client design: the head-side ClientServer accepts
the connection, spawns a dedicated session-host process (a REAL driver
inside the cluster), and relays bytes; the thin ClientRuntime replays
BaseRuntime operations over that link.
"""

from .runtime import ClientRuntime  # noqa: F401
from .server import ClientServer  # noqa: F401
