"""Cross-host serving tier: wire protocol, per-host RPC servers, and the
cluster front door (routing, budget arbitration, host-level failover)."""
from repro_torch.net.frontdoor import (ClusterError, ClusterFrontDoor,
                                 ClusterTicket, HostHandle, PartitionPlan)
from repro_torch.net.host import HostServer, build_host, open_stores
from repro_torch.net.wire import (DeadlineExpired, Heartbeater, RemoteError,
                            WireClient, WireError, WireServer, decode_frame,
                            encode_frame, read_frame, write_frame)

__all__ = [
    "ClusterError", "ClusterFrontDoor", "ClusterTicket", "HostHandle",
    "PartitionPlan", "HostServer", "build_host", "open_stores",
    "DeadlineExpired", "Heartbeater", "RemoteError", "WireClient",
    "WireError", "WireServer", "decode_frame", "encode_frame",
    "read_frame", "write_frame",
]
