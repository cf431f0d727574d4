"""OPC UA real-time interface (port of the JAX package's ``opcua``;
reference: do_mpc/opcua/).

Host-side Python, as in the JAX package: the namespace / tag plumbing
(Namespace, NamespaceEntry, RTBase) wraps the port's objects and imports
without the optional ``asyncua`` package; the network client and server
(RTClient, RTServer) need it and are None when it is absent.
"""
from ._helper import ServerOpts, ClientOpts, NamespaceEntry, Namespace
from ._base import RTBase

try:
    from ._client import RTClient
    from ._server import RTServer
except ImportError:          # asyncua not installed
    RTClient = None
    RTServer = None

__all__ = ["RTServer", "RTClient", "RTBase", "Namespace", "NamespaceEntry",
           "ServerOpts", "ClientOpts"]
