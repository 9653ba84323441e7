"""Real transports for the protocol plane — the part of handel_tpu/network/
that the port has: the wire codecs and the byte counter (encoding.py), the
UDP, TCP and TLS ("quic") transports (udp.py, tcp.py, quic.py, stream.py),
the chaos plane (chaos.py: `ChaosConfig`, the `[chaos]` TOML section, and
the fault-injecting `ChaosNetwork`), the geo planet model (geo.py:
`GeoNetwork`, region-pair WAN delay over the chaos wrapper) and the
transport demo (`python -m handel_tpu_torch.network.examples`).

The in-process transport lives in core/test_harness.py; these sockets carry
protocol traffic between processes and hosts. Signature batches ride the
separate host-to-device plane (parallel/batch_verifier.py), never these
sockets.
"""

from handel_tpu_torch.network.chaos import ChaosConfig, ChaosNetwork
from handel_tpu_torch.network.encoding import (
    BinaryEncoding,
    CounterEncoding,
    Encoding,
)
from handel_tpu_torch.network.tcp import TCPNetwork
from handel_tpu_torch.network.quic import QUICNetwork
from handel_tpu_torch.network.udp import UDPNetwork

__all__ = [
    "Encoding",
    "BinaryEncoding",
    "CounterEncoding",
    "ChaosConfig",
    "ChaosNetwork",
    "UDPNetwork",
    "TCPNetwork",
    "QUICNetwork",
]
