"""Multi-host pieces of the port: the host heartbeats."""

from . import multihost
from .multihost import (HostHeartbeat, detect_dead_hosts, read_heartbeats,
                        retire_heartbeat, write_heartbeat)

__all__ = ["HostHeartbeat", "detect_dead_hosts", "multihost",
           "read_heartbeats", "retire_heartbeat", "write_heartbeat"]
