"""The shared verify plane: many co-located logical nodes, one device plane.

`BatchVerifierService` (batch_verifier.py) fuses every node's verify
candidates into shared launches over a `DevicePlane` (plane.py) of device
engines; mesh_plane.py holds the dual-mode routing policy it consults and
the mesh lane's engines, and sharding.py the mesh one engine spans
(`BN254Device(mesh_devices=K)`). rpc_verifier.py serves a service to
processes without an engine over TCP, and telemetry.py samples the card's
state for the metrics plane.
"""

from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
from handel_tpu_torch.parallel.plane import DeviceLane, DevicePlane
from handel_tpu_torch.parallel.sharding import (
    make_mesh,
    sharded_masked_sum_g2,
    sharded_pairing_check,
)

__all__ = [
    "make_mesh",
    "sharded_pairing_check",
    "sharded_masked_sum_g2",
    "BatchVerifierService",
    "DeviceLane",
    "DevicePlane",
]
