"""pw.io.http — REST ingress/egress (reference: python/pathway/io/http).

`rest_connector` turns HTTP requests into stream rows and completes the
response from a result table's change stream (reference:
io/http/_server.py:482 PathwayWebserver, :696 rest_connector).
"""

from pathway_tpu_torch.io.http._server import (
    EndpointDocumentation,
    PathwayWebserver,
    rest_connector,
)
from pathway_tpu_torch.io.http._client import read, write

__all__ = [
    "PathwayWebserver",
    "EndpointDocumentation",
    "rest_connector",
    "read",
    "write",
]
