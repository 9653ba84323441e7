"""PyTorch + CUDA port of handel_tpu: the Handel protocol core, the shared
batch verifier, BLS-over-BN254 batch verification on the CIOS and the RNS
field backends, per candidate or by the RLC batch check, and the sim's
localhost run path with its faults (chaos, byzantine roles) and its
observability (span traces, the metrics endpoint).

The JAX package (`handel_tpu`) stays the reference. This package imports
torch and numpy, never jax and nothing of `handel_tpu`; module names mirror
the reference so each counterpart is easy to find:

  ops/bn254_ref.py       scalar BN254 oracle (a copy of the reference's)
  ops/fp.py              Field: limb tensors, carry-lookahead add/sub, and the
                         Montgomery multiply (CUDA kernel on the card, its
                         plain PyTorch version on the CPU); the backend seam
  ops/rns.py             RnsField (backend "rns"): per-mul RNS products and
                         the residue-resident form, whose products run the
                         second CUDA kernel
  ops/tower.py           Fp2/Fp6/Fp12 with batch stacking
  ops/curve.py           G1/G2 complete projective formulas, sums, scans,
                         the windowed multi-scalar multiplication
  ops/pairing.py         batched optimal-ate pairing and pairing check
  models/bn254.py        host scheme: keys, sign, wire formats
  models/bn254_torch.py  BN254Device (range and dense launch classes, the
                         RLC launch class, mixed-message launches, the
                         batched G1 combine), BN254TorchConstructor,
                         BN254TorchScheme
  models/rlc.py          the RLC batch check: scalars, bisection, the
                         host-math combined check
  models/fake.py         the fake scheme, for fast protocol tests
  models/registry.py     scheme names -> schemes (`bn254-cuda` verifies on
                         the engine; the JAX package's device names too)
  parallel/              the shared batch verifier (batch_verifier.py:
                         BatchVerifierService) over a device plane
                         (plane.py), with its mode policy (mesh_plane.py),
                         its TCP front for hosts without a card
                         (rpc_verifier.py) and the card's telemetry
                         (telemetry.py)
  service/               the tenant queue (fairness.py) and the host-math
                         device engine (driver.py: HostDevice)
  csrc/, kernels/        the hand-written CUDA sources and their nvcc build
  core/                  the protocol: Handel (handel.py), the signature
                         store, the batched verify pipeline and its
                         device-combine shim (processing.py), partitioner,
                         packets, config, timeouts, peer scoring, bitset,
                         scheme interfaces, the in-process harness
                         (test_harness.py: LocalCluster), the span flight
                         recorder (trace.py) and the metrics plane
                         (metrics.py)
  network/               the UDP and TCP transports, their wire codecs and
                         the fault-injecting ChaosNetwork (chaos.py)
  sim/                   python -m handel_tpu_torch.sim: TOML config, keygen
                         and registry CSV, node processes behind UDP
                         barriers, the monitor's results CSV, byzantine
                         roles (adversary.py) and the trace analyzer
                         (trace_cli.py, the `trace` subcommand)
  lifecycle/             validator-set rotation on the engines
                         (epoch.py: EpochManager), the lane autoscaler, the
                         critical-path autotuner and the controller ticking
                         them
  obs/                   SLO burn-rate detection, incidents, the alert plane
                         and the fleet roll-up
  scenario/              the WAN scenario engine: planets, stake weights,
                         membership schedules (joins, departures)
  swarm/                 thousands of virtual nodes on one host: the timer
                         wheel's driver, the registry pager, the router
  baselines/             the gossip and gossipsub comparison protocols
  scripts/               the labs, the smokes (CI's gates on the CPU), the
                         verify launch's stage profile (verify_profile.py)
                         over the reference's candidate batch
                         (launch_problem.py), capture and eddsa_compare
  utils/torchenv.py      device choice: `cuda` by default, `cpu` on request
                         (the sim's processes: $HANDEL_TORCH_DEVICE)
  utils/breaker.py       the circuit breaker of the service's device lanes
  utils/opcount.py       kernel-launching ops per verify launch (and RLC
                         launch) and per combine, on the CPU

Entry points run on `cuda` unless the caller passes `device="cpu"`. The
names below are the reference's package surface; importing them pulls in
no torch.
"""

__version__ = "0.1.0"

from handel_tpu_torch.core.bitset import BitSet
from handel_tpu_torch.core.config import Config, default_config
from handel_tpu_torch.core.crypto import (
    Constructor,
    MultiSignature,
    PublicKey,
    SecretKey,
    Signature,
    verify_multisignature,
)
from handel_tpu_torch.core.handel import Handel
from handel_tpu_torch.core.identity import ArrayRegistry, Identity, Registry

__all__ = [
    "BitSet",
    "Constructor",
    "MultiSignature",
    "PublicKey",
    "SecretKey",
    "Signature",
    "verify_multisignature",
    "Identity",
    "Registry",
    "ArrayRegistry",
    "Config",
    "default_config",
    "Handel",
]
