#!/usr/bin/env python3
"""Bring-up check of the PyTorch + CUDA port (handel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero with no result line:

  1. device   the card's name, and its name and power limit from nvidia-smi
  2. build    nvcc builds every kernel source of the port (csrc/*.cu), one
              process per source, all at once; per kernel instance its
              registers, spills and static shared memory (ptxas), B2's
              dynamic shared memory and its IMMA (int8 tensor-core)
              instructions in the built SASS (cuobjdump); a B2 instance
              without IMMA, or a B1 or B2 instance that spills, fails
  3. ragged   B1 (each lanes-per-column instance) and B2 (each tile width)
              against their plain versions, exactly, at 1, 7, 31, 33, 63,
              65, 127, 129, 4099 and 13,824 columns, contiguous and as a
              row slice at a column offset of 3 (rows not 16-byte aligned)
     kernel   kernel B1, the Montgomery multiply (Field.mul on CUDA tensors),
              against its plain PyTorch version on the card, exact equality,
              for BN254 (16 limbs) and BLS12-381 (24 limbs): 2^20 seeded
              random columns plus edge columns, and the widths the verify
              path gives it (an Fp12 multiply at 128 lanes; the widest
              stacked G2 add of the dense class; phase 14's widest, the
              prefix scan's G2 add at 73,728 columns), and at 24 limbs phase
              11's (BLS_B1_WIDTHS: its Fp12 multiply at 64 lanes, its
              widest dense add, 64 and 1,152 columns); kernel and plain
              times, and the device time of each lanes-per-column instance
     rns_kernel  kernel B2, the resident RNS Montgomery multiply
              (RnsField.mul_resident on CUDA tensors), against its plain
              version, exact equality, for BN254 (k_all 46) and BLS12-381
              (k_all 65): 2^20 + 16 random residue columns with 0 and m_i - 1
              first, an Fp12 multiply at 128 lanes, and at k_all 65 phase
              11's widths (BLS_B2_WIDTHS: 6,912, 768, 64 and 1,152 columns);
              the integer identity
              x y M^-1 mod p through the resident conversions on a prefix;
              the device time of each tile width
     lab_kernel  kernels B3a and B3b, the kernel lab's two formulations of
              B1's product (csrc/lab_mont.cu), every instance (1, 2, 4 warps
              a block) against its plain version and against B1, exact
              equality, at 16 limbs (2^20 + 16 columns with edge pairs, the
              lab's batch 2^18, an Fp12 multiply at 128 lanes) and 24 limbs
              (2^20 + 16); and against its plain version on the lab's own
              race inputs, 2^18 columns of raw 16-bit digits; the device
              time of every instance at 2^20 + 16 and 2^18 columns; each
              instance's SASS instructions per column (cuobjdump; a B3b
              instance without IMMA, or either without IDP, fails), and
              B3b's dynamic shared memory
              Every kernel figure of phase 3 is a device time per call: chains
              of calls captured in one CUDA graph and replayed, by
              chained_marginal's slope (handel_tpu_torch/ops/fp.py), each
              call reading operands that no recent call left in the L2 cache
              (ColdOperands), so the bytes bound holds at every width; the
              back-to-back eager figure, which measures the host's issue
              rate at narrow widths, stays beside it as `eager_ms`. One graph
              per kernel, of dependent calls, is replayed over a sentinel
              and held against an eager chain of the same depth, exactly.
  4. verify   BN254TorchScheme on a 4096-key registry with 128 lanes: a range
              launch of 64 candidates and a dense launch of 126, each with
              forged lanes (wrong signature, wrong message), an empty bitset
              and padded lanes; verdicts must equal the ones known by
              construction, and B1's launch counter must grow during the
              run; a small pairing is held against the scalar oracle; wall
              ms per launch class (`p50_ms`: the one main-path launch since
              phase 16 came, the median of two before), kernel launches per
              verify, peak device memory
     rns_verify  the same launches through BN254TorchScheme(fp_backend="rns")
              (the resident pairing): the same verdicts, B2 launched and B1
              not, conversion counts, p50 per class, peak memory; a 2-lane
              resident pairing against the scalar oracle. Each path prints
              its kernel's calls by column count (`widths`)
  5. profile  one range launch of each path under torch.profiler: device
              activities, busy time against wall time, the costliest kernels;
              the path's kernel's device ms against the sum of its bound
              over the launch's calls
  6. lab      the kernel lab (python -m handel_tpu_torch.scripts.fp_kernel_lab)
              at its batch 2^18, the outer-product lab
              (...scripts.mxu_limb_lab) at 2^15 with the card's int8 ceiling,
              and the production field's marginal rate for cios and rns
              (python -m handel_tpu_torch.ops.fp): muls/s per candidate, each
              candidate validated first; any failure fails the run. B3a and
              B3b must run here, B2 must not; the kernels a lab run executed
              are its wrapper counts less the calls captured into graphs plus
              the calls the graphs replayed.
  7. round    a Handel round through the port alone: the port's LocalCluster
              of 5 nodes on BN254TorchScheme(batch_size=128) (cios), with a
              forged level-1 candidate (a one-bit multisignature signed by a
              key outside the registry) injected into node 0 before the wait.
              Every node's final signature must reach the threshold and
              verify on the host oracle, the forgery must fail a device
              verdict (sigVerifyFailed >= 1), the store's merges must reach
              the device combine (combineDeviceGroups >= 1), B1 must launch
              and B2, B3a, B3b must not; an exception out of the
              constructor's batch_verify or device_combine, or a dead node
              task, fails the round at once. The line gives the wall time from
              start() to the last final signature, the verify launches and
              candidates, the per-launch verify p50, the combine groups,
              B1's calls by column count and peak device memory.
  8. service  the shared batch verifier (parallel/batch_verifier.py), every
              service built with fallback=None:
     load     one BatchVerifierService(max_inflight=2) over phase 4's
              prepared cios engine (4096 keys, 128 lanes) takes four
              sessions of 64 range candidates at once, forged lanes among
              them: every verdict as known by construction, 2 or 3
              launches, launch fill >= 0.6, B1 launched and B2, B3a, B3b
              not. Printed: wall, candidates/s (verify throughput under
              load), launches, fill, host pack and dispatch ms per launch,
              the seconds in which a dispatch and a fetch were in flight
              together, peak memory, B1's calls by column count.
     round    an 8-node Handel round on BN254TorchScheme(batch_size=128),
              cios, every node verifying through one service over the
              prepared engine (Config.verifier = service.verify, with
              InfiniteTimeout and random.Random(1 + i)), phase 7's forgery
              into node 0: every final signature at the threshold and
              verifying on the host oracle, sigVerifyFailed >= 1, device
              combine groups >= 1, fewer launches than nodes, dedup hits
              >= 1, B1 launched and B2, B3a, B3b not.
     round_rns  the same round on fp_backend="rns": B2 launched, B3a, B3b
              not, B1's count printed as it comes. It was 16 nodes until
              phase 14 came; the cios round was 16 until phase 15 came.
              In every phase-8 run no failover, no retry, the breaker
              closed at the end; an exception out of a lane's dispatch or
              fetch or out of device_combine fails the run at once.
              The rounds were 128 nodes until phase 9 took over the
              128-node service path at full width, then 32 until phase 10
              came, and 16 until phases 14 and 15 came, to keep the script
              inside its time limit (16 is the smallest case of the CPU
              parity test that holds this round to the JAX package's,
              tests/test_torch_service_engine.py).
  9. sim      the port's entry point as a user runs it, in a subprocess with
              a time limit: python -m handel_tpu_torch.sim --config
              <tmp>/sim.toml --workdir <tmp>, where sim.toml is the repo's
              results/handel_128_device.toml (two node processes sharing
              the card, UDP, one shared verifier per process) loaded and
              dumped by the port's sim/config.py with scheme "bn254-cuda",
              fp_backend "cios", max_timeout_s 600 and batch_size 128 (the
              file's 16 lanes would need about 190 host-bound launches in
              each process), and its run cut from 128 nodes to 64, threshold
              120 to 60, to pay for phase 12, then to 16 nodes, threshold
              15, to pay for phase 13. The run must exit 0,
              every node process must print `finished OK` (each node checks
              its own final signature on the host) and a `node process
              kernels` line in which its shared verifier launched at least
              once and B1 launched; the results CSV must show candidates,
              the sigen wall, the device_launch columns and merges on the
              device combine. The service there has no host fallback, so a
              device fault fails the run. The line gives the wall, the
              CSV's launches, candidates and occupancy, the sigen wall, the
              launch and dispatch times, and each process's verifier
              launches, peak device memory, B1 launches and seconds in
              device combines (from its `node process kernels` line).

 10. rlc      the RLC batch check (batch_check="rlc", models/rlc.py) and the
              mixed-message launch (dispatch_multi) at 4096 keys and 128
              lanes, on RLC engines (BN254Device(bank=...)) over phase 4's
              registry banks and prefix tables, each launch's scalars from a
              seeded random.Random: (b) one honest dense launch of 126,
              one message: every verdict True, one combined check, 2 Miller
              lanes and 1 final exponentiation, B1 launched and B2, B3a,
              B3b not ((a), the honest range launch of 128, was cut to pay
              for phase 16: the range class runs in (c), (d) and (f));
              (c) one BatchVerifierService(fallback=None) over the RLC
              engine, four sessions of 32 range candidates on four messages:
              one launch, fill 1.0, G = 4 groups (5 Miller lanes),
              rlcLaunches 1, no failover, retry or open breaker; (d) a
              forged pair (one candidate signed over another message):
              verdicts [True, False], bisection 2 and depth 1, two
              per-candidate oracle launches beside the combined one; (e)
              one per-candidate dispatch_multi launch of 128 lanes over four
              messages on phase 4's engine, with phase 4's forged lanes: the
              verdicts known by construction, one multi-message launch; (f)
              one honest RLC range launch on the rns backend: B2 launched,
              B1 not (its MSMs run on the rns field, as in the reference).
              Each case prints its wall, host pack and dispatch ms per
              launch, RlcStats, launches and B1's and B2's calls by column
              count; the summary line its peak memory, (b)'s and (f)'s
              walls over phase 4's per-candidate p50 of the same class and
              backend, and each cios case's wall over case (e)'s, the
              per-candidate launch of the same phase.
 11. bls12_381  the BLS12-381 family through new_scheme("bls12-381-cuda") at
              the repo's shape for it (scripts/bench_bls12.py): a 1024-key
              registry from small seeded scalars, 64 lanes. On cios, one
              range launch of 32 candidates (n/8 to n/2 keys, up to 4
              holes) and one dense launch of 62 random quarter subsets; on
              rns one range launch; each with phase 4's forged lanes, empty
              bitset and padded lanes, and each class's one launch is also
              its timed one. Verdicts as known by construction; B1 launches
              on cios at 24 limbs only, B2 on rns at k_all 65 only, and
              nothing else launches on either path (each path one main-path
              run). Then a 2-lane pairing on each engine's curves against
              the port's copy of the BLS12-381 scalar oracle, and batched G1
              combines (classes 2, 4, 8, one group summing to infinity) on
              each engine against the oracle's sums: both on the cios field,
              B1 alone at 24 limbs. Then B1 (24 limbs) and B2 (k_all 65)
              against their plain versions, exactly, at every column count
              the phase's launches gave them. Each launch prints its wall,
              B1's or B2's calls by column count and row count with the sum
              of their bounds, and its peak device memory; the summary line
              the nvidia-smi name and power limit.
 12. adversarial  the port's sim on the repo's results/handel_adversarial.toml
              (64 nodes, threshold 33, cut to 32 and 17 to pay for phase 13
              (ADV_RUN_CHANGES), 4 node processes sharing the card,
              UDP, [chaos] drop 0.10, corrupt 0.05, duplicate 0.05, seed 99,
              4 invalid signers, 2 stale replayers and a flooder at 100
              packets/s, period 100 ms, timeout 200 ms), as phase 9 runs its
              config, with scheme "bn254-cuda", fp_backend "cios",
              shared_verifier, batch_size 128, trace and metrics on,
              metrics_linger_s 5 and trace_capacity 2^20 (ADV_CHANGES), under
              a limit of ADV_LIMIT_S. While it runs: each process's endpoint
              from metrics_ports.json answers /healthz and turns ready on
              /readyz; a /metrics scrape of each carries the device_verifier
              plane and the card's memory gauges above 0 (torch.cuda.
              memory_stats); a /debug/profile capture of 2 s on the first
              process shows B1's kernel by name. After it: `run 0: success`,
              `finished OK` in every process, each process's verifier
              launched and B1 launched in its round; forgeries failed device
              verdicts (sigVerifyFailed > 0) and were attributed to their
              senders (peerPenaltyReports > 0), and every origin a scorer
              banned, if any, is byzantine (whether a ban comes within the
              round depends on its timing; the ban case below makes one);
              chaos dropped, corrupted and duplicated packets; no
              failover, retry or breaker transition; one trace per process
              naming the service thread and its device lane, each ring
              unwrapped, with as many launch spans as the CSV's launches;
              the trace CLI (python -m handel_tpu_torch.sim trace <dir>
              --critical-path --report r.json) exits 0 and its critical path
              runs through recv, verify and merge and covers 90% of the time
              to threshold or more once its node threads' own merges count
              (a verified candidate waits for the node to merge the batch's
              earlier candidates, each with a device combine; the CLI's own
              coverage, which leaves that wait out, is printed beside it).
              The line adds each launch's queue, pack-and-dispatch,
              on-device and fetch times from the spans and the lane
              occupancy. A launch's on-device span is its time on the
              verify stream, from its first op to its last (CUDA events,
              models/bn254_torch.py `device_span`), so the lanes' mean
              occupancy must read at least the profile capture's busy share
              (its kernels' device ms over its seconds).
     rpc      a VerifierServer on loopback in front of one
              BatchVerifierService(fallback=None) over phase 4's cios engine;
              four RPCVerifier clients, standing for hosts without a card,
              each ship 32 range candidates with phase 4's forged lanes at
              once: the verdicts as known by construction (a direct launch
              of the same candidates cross-checked them until phase 16
              came), in one launch of 128. Then a
              request in flight when the server stops and its link is cut
              fails with a ConnectionError, and the client's next call, after
              the server restarts on its port, reconnects and gets its
              verdicts.
     ban      node 0 of phase 4's registry, a Handel node verifying through
              one BatchVerifierService(fallback=None) over phase 4's cios
              engine, receives 12 content-distinct aggregates from the
              invalid signer at the top of its level 5 (ids 16..31): the
              signer's forged signature alone, then beside one honest
              signature each. One launch of the 12 on the card rejects them
              all, the node's scorer bans the signer (12 reports over the
              ban score of 8), and the signer's next packet dies at
              validation.
 13. fleet    two runs of the repo's results/handel_watch_16.toml (16 nodes,
              threshold 16, two node processes a host, UDP), loaded and
              dumped by the port's sim/config.py with scheme "bn254-cuda",
              fp_backend "cios", shared_verifier, batch_size 128 and
              max_timeout_s 600 (REMOTE_CHANGES), at once, each in a
              subprocess of its own process group under REMOTE_LIMIT_S:
     remote   python -m handel_tpu_torch.sim --platform remote over two
              localhost-as-remote hosts: host A `device = true`, host B
              without a card. The platform ships the package into each
              host's staging dir; one process of host A builds the kernels
              there, serves its shared verifier over TCP, and every other
              process (A's second, B's two) verifies through it. The run
              must exit `success` with `finished OK` in every process (each
              node checks its own final on the host oracle); the RPC
              counters on the monitor plane above 0 (candidates sent by the
              chip-less processes and served by A's); no failover, retry,
              breaker transition or link error; B1 launched in A's serving
              process only, and no other process initialised CUDA. The line
              gives the wall, the launches, the candidates shipped over RPC
              and B1's calls by width.
     watch    python -m handel_tpu_torch.sim watch on the same config (the
              localhost platform, each node process with a shared verifier
              on the card) with --snapshot and --max-seconds: exit 0, the
              dashboard rendered, the snapshot holds both processes'
              endpoints; the line gives the metric families, and each
              process launched B1.
 14. lifecycle  a live validator-set rotation under load, on phase 4's cios
              engine (4096 keys, bank A, 128 lanes) wired as the serve
              driver wires a device (MultiSessionCluster(device=engine): one
              BatchVerifierService with no fallback, its SessionManager, its
              AlertPlane with the breaker-storm and queue-depth detectors),
              an EpochManager, and a LifecycleController ticking the alert
              plane every 0.25 s. Four sessions of 32
              range candidates at a time, with phase 4's forged lanes: one
              launch under A (epoch 0); a second batch under A in flight
              while `begin_rotation` stages bank B (4096 keys from another
              seed: the flip is an equal-size pointer swap) on the engine's
              registry stream, then `commit_rotation`; one launch under B
              (epoch 1), in which one epoch-0 candidate comes again with the
              same session, message and bytes and must be no dedup hit and
              verify False; `rotate(A[:2048])`, a size change that re-makes
              the staging buffers, and one launch of candidates in [0, 2048)
              (epoch 2). Every future resolves and every verdict is exact
              for its bank; service, engine and session manager at epoch 2;
              B1 launched inside each staging (counted on the staging's own
              thread) and never inside `activate_staged`; no failover,
              retry, admission refusal or open breaker; no incident opened;
              the controller ticked. The line gives each staging's ms and B1
              calls by width, the swap stalls, the launches per epoch and
              those that overlapped a staging, and the second bank's bytes
              and allocation delta.
15. weighted  the port's sim on the repo's results/geo_weighted.toml, its
              [[runs]] table (stake weights from the pareto profile with
              seed 7, a gate of 0.55 of the stake, the 5-region planet with
              3 ms jitter, churners leaving 400 ms after the start, UDP,
              period 10 ms, timeout 50 ms), as phase 9 runs its config, with
              scheme "bn254-cuda", fp_backend "cios", shared_verifier,
              batch_size 128 and max_timeout_s 600 (GEO_CHANGES), and its
              run cut from 128 nodes in 1 process to 16 in 2 processes
              sharing the card, its 12 churners to 2 (GEO_RUN_CHANGES; it
              was 32 nodes in 4 processes with 3 churners until the script
              ran over 1,000 s); threshold 0 resolves to 9, the gate to 8.8
              of 16. The run
              must exit `success` with `finished OK` in every process (each
              node checks its own final on the host oracle) and no STALLED
              line; each honest node's final stake at or over the gate and
              the gate the one derived here from the port's make_weights;
              each honest node marked every churner of its own process as
              departed, and no node found the threshold unreachable; the
              CSV shows geo-delayed sends; each process's verifier launched
              and B1 launched in its round, with no failover, retry or
              breaker transition; no node process wrote a traceback (a send
              fired after its network stopped is dropped, ROADMAP §C C3).
              The line gives the wall, the sigen wall (time to threshold),
              launches, candidates, fill, departures, the achieved stakes
              beside the gate, and B1's calls by process.
16. mesh      the multi-device verify plane (parallel/sharding.py,
              parallel/mesh_plane.py) over phase 4's registry and curves: a
              mesh of 2 shards (cuda:0 and cuda:1 when two cards are
              visible, else two shards on cuda:0; the line says which), each
              shard's work issued in turn on its own stream.
              (a) bn254_mesh_engine(pks, devices=2, batch_size=8) makes one
              range launch of 8 candidates and one dense launch of 8
              scattered quarter subsets (far more holes than MISS_CAP), one
              forged signature in each: the verdicts as known, the dense
              launch's sharded aggregate (affine) equal to phase 4's
              single-card masked sum of the same mask, B1 launched inside
              each launch (counted by card, both cards when there are two),
              mesh_launches 2. (b) The same engine as the mesh lane of a
              BatchVerifierService(fallback=None, recorder) whose
              throughput lane is phase 4's engine (enable_latency_plane,
              ModePolicy(small_batch_max=8)): a gold-tier group of 8 rides
              the mesh (meshLaunches 1, modeLatencyLaunches 1, its span
              launch_on_mesh), then a standard-tier group of 64 stays on
              the card's lane (launch_on_device); every verdict exact, no
              mesh fallback, failover, retry or open breaker. The line
              gives each mesh launch's wall beside phase 4's p50 of its
              class, the service groups' walls and spans, and B1 by card.
              It runs right after phase 5, since phase 14 rotates phase
              4's engine off its registry. Phase 4's timed second launch
              of each class, phase 10's honest single-message range case
              and phase 12's RPC case's direct cross-check launch were cut
              to pay for it.
17. stages    the verify launch's stage profile
              (handel_tpu_torch/scripts/verify_profile.py `profile`) over
              phase 4's cios and rns engines and its range requests, with
              their forged lanes 1-3: one range launch packed and staged by
              the engine's own packer, then cut at its stage boundaries (range
              aggregation, the affine step, the Miller loop at 2C lanes, the
              product and final exponentiation with the comparison to 1),
              each stage the launch's own method. Per backend: the stages,
              composed, give the full launch's verdicts, and those are the
              known ones (lanes 1-3 rejected); the stages' kernel launches add
              up to the full launch's; B1 runs in every cios stage and B2 in
              none; on rns B2 runs in the Miller loop and the final
              exponentiation (the resident pairing) and no kernel in the
              aggregation and the affine step (the per-mul RNS product, plain
              torch), B1 nowhere. Each stage and the
              full launch are the p50 of 2 calls and the pipelined per-launch
              time is one round of 2 launches (`measure_pipelined`), all
              without warm calls: phase 4's launches ran these engines
              before. The line gives each stage's p50 ms and launches, the
              stage sum beside the full launch, the pipelined per-launch ms
              and the dispatch floor (`x + 1` on an (8, 128) tensor and a
              16-word fetch). It runs right after phase 16, before phase 14
              rotates phase 4's engine.

Two processes share the card. The first runs phases 1-3 and 6 alone, so
that their timings see no other work, and then starts the second
(`chip_smoke.py --worker DIR`, WORKER_PHASES: phases 7, 8's rounds, 9,
12's sim, 13, 15 and 11, in that order), which needs none of phase 4's
state. The first goes on with phases 4, 5, 16, 17, 8's load, 10, 12's RPC
and ban cases and 14, then prints the second's lines and takes its figures; a
failure of either fails the run, and a failure of the first, or a SIGTERM,
stops the second and the node processes of its sim. Each process issues
its launches from a core of its own: the launches are host-bound, so
the two lists overlap, and every wall from phase 4 on is taken beside the
other process's work on the card.

Each path of phases 4, 6, 7, 8, 10, 11, 12's RPC and ban cases, 14, 16 and
17 is one main-path run: every kernel's launch count (its process's own) is
set to 0 just before it and read just after; phases 9's, 12's, 13's and
15's sim counts are the node processes' own, which start at 0. Then one
JSON line of kernel figures, the seconds each phase took in each process
(`phases`), the total, the nvidia-smi line again, and last
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import random
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

MSG = b"handel chip smoke"
SEED = 2024
N_REGISTRY = 4096
LANES = 128
RANGE_CANDIDATES = 64
DENSE_CANDIDATES = 126
# launches timed per class after the main-path one, whose wall joins them
# (1 until phase 16 came: the second launch of each class paid for it)
TIMED_LAUNCHES = 0
# the per-node round's committee: every node's launches queue on the one
# event loop, so the fewest nodes whose store merges still reach the device
# combine (groups of 4 points or more; none do at 4 nodes, one does at 5,
# see tests/test_torch_protocol.py::test_per_node_round_sizes)
ROUND_NODES = 5
ROUND_TIMEOUT_S = 600.0
# phase 8: sessions of RANGE_CANDIDATES range candidates at once, and the
# committee of the round through one service
SERVICE_SESSIONS = 4
# (cut from 16 to pay for phase 15)
SERVICE_ROUND_NODES = 8
# ... and on the rns backend, cut from 16 to pay for phase 14
SERVICE_ROUND_NODES_RNS = 8
# phase 10: the mixed-message service launch's sessions, each on its own
# message, LANES / RLC_SESSIONS range candidates each
RLC_SESSIONS = 4
# phase 11: BLS12-381 at the repo's shape for it (scripts/bench_bls12.py:
# 1024 keys from small seeded scalars, 64 lanes, 32 range candidates with
# up to 4 holes, seed 7); the dense launch leaves two lanes padded, as
# phase 4's does
BLS_REGISTRY = 1024
BLS_LANES = 64
BLS_RANGE_CANDIDATES = 32
BLS_DENSE_CANDIDATES = BLS_LANES - 2
BLS_MAX_HOLES = 4
BLS_SEED = 7
# phase 11's main widths, timed and checked in phase 3: the Fp12 multiply
# over the 2C Miller lanes, the dense class's widest stacked G2 add (as
# phase 4's), the 64-column calls of the affine inverse (B1) and of the
# per-lane products (both), and the next most frequent widths
BLS_B1_WIDTHS = {"bls_f12_mul": 54 * 2 * BLS_LANES,
                 "bls_g2_add_dense": 9 * BLS_REGISTRY * BLS_LANES,
                 "bls_narrow": BLS_LANES, "bls_1152": 18 * BLS_LANES}
BLS_B2_WIDTHS = {"bls_f12_mul": 54 * 2 * BLS_LANES, "bls_768": 12 * BLS_LANES,
                 "bls_narrow": BLS_LANES, "bls_1152": 18 * BLS_LANES}
# phase 9: the repo's 128-node device config through the port's sim entry
# point, with these changes (module docstring)
SIM_CONFIG = "results/handel_128_device.toml"
SIM_CHANGES = {"scheme": "bn254-cuda", "fp_backend": "cios", "max_timeout_s": 600.0,
               "batch_size": LANES}
# ... and its run cut from 128 nodes to 16 (threshold 120 to 15, the same
# 15/16 of the committee): to 64 to pay for phase 12, then to 16 for 13
SIM_RUN_CHANGES = {"nodes": 16, "threshold": 15}
# the subprocess's own limit: a stalled barrier fails inside max_timeout_s
SIM_LIMIT_S = 660.0
# phase 12: the repo's adversarial config (64 nodes, threshold 33, 4 node
# processes, UDP, [chaos], 7 byzantine nodes) through the port's sim entry
# point, traced and scraped, with these changes. The ring holds the whole
# run, so that every launch span is in the trace (the file's default of
# 2^16 events per process would keep only the run's last window).
ADV_CONFIG = "results/handel_adversarial.toml"
ADV_CHANGES = {"scheme": "bn254-cuda", "fp_backend": "cios", "shared_verifier": True,
               "batch_size": LANES, "trace": True, "metrics": True,
               "metrics_linger_s": 5.0, "trace_capacity": 1 << 20}
# ... and its run cut from 64 nodes to 32 (threshold 33 to 17, the same
# half of the committee and then one) to pay for phase 13
ADV_RUN_CHANGES = {"nodes": 32, "threshold": 17}
# its subprocess limit, below the config's max_timeout_s of 600
ADV_LIMIT_S = 540.0
# phase 13: the repo's watched 16-node config through the remote platform
# (one card host serving a chip-less host) and through `sim watch`, with
# these changes (module docstring); the file's 60 s would not cover host
# A's kernel build and prepare before the START barrier
REMOTE_CONFIG = "results/handel_watch_16.toml"
REMOTE_CHANGES = {"scheme": "bn254-cuda", "fp_backend": "cios", "shared_verifier": True,
                  "batch_size": LANES, "max_timeout_s": 600.0}
# the subprocesses' limit, and watch's --max-seconds under it
REMOTE_LIMIT_S = 480.0
WATCH_MAX_S = 420.0
# the /debug/profile capture's seconds, and how many captures may miss B1
PROFILE_S = 2.0
PROFILE_TRIES = 3
# the verifier RPC case: clients standing for hosts without a card, each
# shipping RPC_CANDIDATES range candidates at once
RPC_CLIENTS = 4
RPC_CANDIDATES = LANES // RPC_CLIENTS
# phase 12's ban case: node 0's level of ids 16..31 in phase 4's registry,
# the invalid signer's forged aggregates (over PeerScorer's ban score of 8),
# and the seconds its one launch may take
BAN_LEVEL = 5
BAN_FORGED = 12
BAN_LIMIT_S = 120.0
# phase 14: sessions of range candidates at once, filling one launch; the
# controller's tick; the seed of bank B's keys
LIFECYCLE_SESSIONS = 4
LIFECYCLE_CANDIDATES = LANES // LIFECYCLE_SESSIONS
LIFECYCLE_TICK_S = 0.25
LIFECYCLE_SEED = SEED + 14
# phase 15: the repo's weighted, churning geo config through the port's sim
# entry point, with these changes (module docstring)
GEO_CONFIG = "results/geo_weighted.toml"
GEO_CHANGES = {"scheme": "bn254-cuda", "fp_backend": "cios", "shared_verifier": True,
               "batch_size": LANES, "max_timeout_s": 600.0}
# ... and its run cut from 128 nodes in one process to 16 in two, its 12
# churners to 2 (about the same share of the committee): 32 nodes in four
# processes with 3 churners put the script over 1,000 s of its 1,200
GEO_RUN_CHANGES = {"nodes": 16, "processes": 2}
GEO_CHURNERS = 2
# its subprocess limit, below the changed max_timeout_s of 600
GEO_LIMIT_S = 540.0
# phase 16: the mesh (parallel/sharding.py) over phase 4's registry: two
# shards (two cards when two are visible, else two shards on cuda:0), and
# the mesh lane's launch width, sim/config.py's mesh_batch_size default
MESH_SHARDS = 2
MESH_BATCH = 8
# the lanes of phase 16's launches whose signatures are forged
MESH_FORGED_RANGE = 5
MESH_FORGED_DENSE = 2
# phase 17: calls a stage's p50 is taken over, and the pipelined round's
# launches (one round), on engines that phase 4 warmed
STAGE_TRIALS = 2
STAGE_DEPTH = 2
# the phases that run in a second process of the script (`--worker`), in
# this order, beside the first process's phases 4, 5, 16, 17, 8's load, 10,
# 12's RPC and ban cases and 14: they need none of phase 4's state, and each
# process issues its launches from a core of its own, so that the script
# takes about the longer of the two lists (one process took their sum,
# 967-1,072 s of the 1,200 on an H100 80GB HBM3 at 700 W). Phase 11 moved
# here when phase 17 came, so that the first process stays the shorter
WORKER_PHASES = ("round", "service_round", "service_round_rns", "sim", "adversarial",
                 "fleet", "weighted", "bls12_381")
# the first process's wait for the second, from the script's start: a
# second process still running then is stopped, and the run fails
WORKER_DEADLINE_S = 1140.0
# the seconds a stopped second process has to stop its sims' node processes
WORKER_STOP_S = 30.0
# a secret key outside the round's registry (its keys come from
# new_keypair(seed=i), SHA-256 derived): the forger of phase 7
FORGER_SCALAR = 0x5EED_F0E6
BLS12_381_P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab",
    16,
)
# H100 SXM data-sheet rates: HBM3 3.35 TB/s; int32 64 lanes per SM per clock
# (half the 128 FP32 lanes behind the 67 TFLOP/s FP32 figure) x 132 SMs x
# 1.98 GHz = 16.7 T int32 operations/s
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
L2_BYTES = 50 << 20  # H100 L2 cache, 50 MB


def line(phase: str, **kw) -> None:
    print(f"{phase}: " + json.dumps(kw, sort_keys=True), flush=True)


class PhaseClock:
    """The seconds each phase took, each from the end of the one before."""

    def __init__(self) -> None:
        self.start = self.last = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.last
        self.last = now


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` calls, by CUDA events (warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class ColdOperands:
    """fn over a ring of copies of (a, b) that holds more than twice the L2
    cache, for chained_marginal: each call ignores the chain's operands and
    takes the ring's next pair, so what it reads was last touched a ring's
    worth of bytes ago. The first call of a chain (chain() hands it the
    chain's start, `a`) first reads a buffer of twice the L2 size, which
    evicts what an earlier replay of the same graph left there; that fixed
    cost per chain cancels in chained_marginal's slope. So every call reads
    its operands from device memory, and the bytes bound (inputs over HBM
    bandwidth) is a bound at every width."""

    def __init__(self, fn, a, b):
        import torch

        per_call = (a.numel() + b.numel()) * a.element_size()
        copies = -(-2 * L2_BYTES // per_call)
        self.ring = [(a, b)] + [(a.clone(), b.clone()) for _ in range(copies - 1)]
        self.evict = torch.ones(2 * L2_BYTES // 4, dtype=torch.int32, device=a.device)
        self.a, self.fn, self.calls = a, fn, 0

    def __call__(self, out, _b):
        if out is self.a:
            self.evict.max()
        x, y = self.ring[self.calls % len(self.ring)]
        self.calls += 1
        return self.fn(x, y)


def graph_ms(fn, a, b) -> float:
    """Device time of one call of fn on (a, b), in ms, operands read from
    device memory: the slope of 8- and 72-deep chains of calls, each captured
    in one CUDA graph and replayed (chained_marginal), the calls taking their
    operands from a ColdOperands ring. Raises when the slope is not
    measurable."""
    from handel_tpu_torch.ops.fp import chained_marginal

    rate, _floor = chained_marginal(ColdOperands(fn, a, b), a, b, k1=8, k2=72, trials=5)
    if rate is None:
        raise AssertionError("graph chain slope not measurable")
    return a.shape[1] / rate * 1e3


def replay_check(fn, a, b, counter, depth: int = 8) -> None:
    """A captured chain of `depth` calls, replayed over a sentinel, must equal
    the eager chain exactly; the wrapper counts its launches at capture
    (3 warm calls and `depth` captured) and not at replay."""
    import torch

    from handel_tpu_torch.ops.fp import ChainGraph, chain

    before = counter.launches
    g = ChainGraph(fn, a, b, depth)
    if counter.launches - before != 3 + depth:
        raise AssertionError(f"capture counted {counter.launches - before} launches")
    g.out.fill_(-1)
    before = counter.launches
    got = g.replay().clone()
    if counter.launches != before:
        raise AssertionError("a graph replay moved the launch counter")
    if not torch.equal(got, chain(fn, a, b, depth)):
        raise AssertionError("graph replay != eager chain")
    del g
    torch.cuda.empty_cache()


def ptxas_summary(log: str) -> dict[str, list[int]]:
    """{kernel<template args>: [registers, spill store bytes, spill load
    bytes, static shared memory bytes]} from nvcc -Xptxas -v output."""
    out, cur, spill = {}, None, [0, 0]
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[cur] = [int(m.group(1)), *spill, int(smem.group(1)) if smem else 0]
            cur, spill = None, [0, 0]
    return out


def kernel_label(mangled: str) -> str:
    """kernel<template args> for a mangled kernel name, else the name."""
    k = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E)+)E", mangled)
    if not k:
        return mangled
    return f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>"


def sass_counts(lib, opcode: str) -> dict[str, int]:
    """{kernel<template args>: instructions of `opcode`} in a built
    library's SASS (cuobjdump -sass, from nvcc's toolkit)."""
    from pathlib import Path

    from handel_tpu_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kernel_label(m.group(1))
            out.setdefault(cur, 0)
        elif cur is not None and re.search(rf"\b{opcode}\b", ln):
            out[cur] += 1
    return out


def mont_mul_bound_ms(nlimbs: int, cols: int) -> tuple[float, str]:
    """Least time for `cols` Montgomery products: the bytes (a and b read
    once, out written once, int32 limbs) over HBM bandwidth against the
    32x32->64-bit multiply-adds of word-serial CIOS (2 N^2 + N per column
    for N = nlimbs/2 words, two int32 multiply-adds each) over the int32
    rate. Returns (ms, "bytes" or "operations")."""
    words = nlimbs // 2
    t_bytes = 3 * nlimbs * 4 * cols / HBM_BYTES_PER_S
    t_ops = 2 * (2 * words * words + words) * cols / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rns_bound_ms(F, cols: int) -> tuple[float, str]:
    """Least time for `cols` resident RNS products (kernel B2): the bytes
    (a and b read once, out written once, K = k_all int32 residues each)
    over HBM bandwidth against the integer operations counted from the
    kernel's code over the int32 rate: each product or multiply-add one,
    each modular reduction two (a quotient multiply and a multiply-
    subtract). Returns (ms, "bytes" or "operations")."""
    kA, kB, K = F.kA, F.kB, F.k_all
    mads = K + kA + (kB + 1) * kA + 2 * (kB + 1) + 2 * kB + 1 + kA * kB + kA
    mods = K + kA + 3 * (kB + 1) + 2 * kB + 2 + 3 * kA
    t_bytes = 3 * K * 4 * cols / HBM_BYTES_PER_S
    t_ops = (mads + 2 * mods) * cols / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def random_residues(F, cols: int, rng: np.random.Generator):
    """(k_all, cols) residues, each row below its modulus, with 0 and
    m_i - 1 in the first two columns."""
    import torch

    m = F._m_all.astype(np.int64)[:, None]
    r = rng.integers(0, 1 << 40, size=(F.k_all, cols)) % m
    r[:, 0], r[:, 1] = 0, m[:, 0] - 1
    return torch.from_numpy(r.astype(np.int32))


def rns_kernel_phase(F, widths: dict[str, int], rng) -> dict:
    """Kernel B2 against its plain version on the card at each width, and
    the integer identity on a prefix; returns per-width figures. Raises on
    any difference."""
    import torch

    from handel_tpu_torch.kernels.rns_mont import TILES, rns_mul_resident, tile_for

    dev = F.device
    out = {}
    for label, cols in widths.items():
        a = random_residues(F, cols, rng).to(dev)
        b = random_residues(F, cols, rng).to(dev)
        before = rns_mul_resident.launches
        got = F.mul_resident(a, b)
        if rns_mul_resident.launches != before + 1:
            raise AssertionError("mul_resident on CUDA tensors did not launch kernel B2")
        want = F._mul_resident_core(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"B2 != plain at k_all={F.k_all} width {label}: max err {err}")
        # the integer identity through the resident conversions
        k = min(cols, 256)
        xs = F.unpack(random_columns(F, k, rng), mont=False)
        ys = F.unpack(random_columns(F, k, rng), mont=False)
        r = F.mul_resident(F.to_resident(F.pack(xs, mont=False)),
                           F.to_resident(F.pack(ys, mont=False)))
        minv = pow(F.M, -1, F.p)
        if F.unpack(F.from_resident(r), mont=False) != [x * y * minv % F.p for x, y in zip(xs, ys)]:
            raise AssertionError(f"B2 != integer identity at k_all={F.k_all} width {label}")
        if label == next(iter(widths)):
            replay_check(F.mul_resident, a, b, rns_mul_resident)
        ms = graph_ms(F.mul_resident, a, b)
        eager_ms = cuda_ms(lambda: F.mul_resident(a, b), 20)
        plain_ms = cuda_ms(lambda: F._mul_resident_core(a, b), 3)
        bound, bound_by = rns_bound_ms(F, cols)
        out[label] = dict(
            k_all=F.k_all, cols=cols, max_abs_err=err, ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            tile=tile_for(cols),
            ms_by_tile=each_instance(rns_mul_resident, "tile", TILES,
                                     lambda: graph_ms(F.mul_resident, a, b)),
        )
        line("rns_kernel", **out[label], width=label)
        del a, b, got, want
        torch.cuda.empty_cache()
    return out


def random_columns(F, cols: int, rng: np.random.Generator):
    """(nlimbs, cols) canonical values < p: uniform limbs below a top limb
    drawn under p's top limb."""
    import torch

    a = rng.integers(0, 1 << 16, size=(F.nlimbs, cols), dtype=np.int64)
    a[-1] = rng.integers(0, int(F.p_limbs_np[-1]), size=cols)
    return torch.from_numpy(a.astype(np.int32))


def operand_pair(F, cols: int, rng: np.random.Generator, with_edges: bool):
    """Two (nlimbs, cols) CPU tensors of canonical values; with_edges puts
    every pair of 0, 1, p-1, R mod p in the first 16 columns."""
    import torch

    a = random_columns(F, cols, rng)
    b = random_columns(F, cols, rng)
    if with_edges:
        edges = [0, 1, F.p - 1, F.mont_r]
        ea = F.pack_batch_np([x for x in edges for _ in edges], mont=False)
        eb = F.pack_batch_np([y for _ in edges for y in edges], mont=False)
        a[:, : ea.shape[1]] = torch.from_numpy(ea)
        b[:, : eb.shape[1]] = torch.from_numpy(eb)
    return a, b


def each_instance(kernel, attr: str, choices, measure) -> dict:
    """{choice: measure()} with the wrapper's `attr` (B1's lanes per
    column, B2's tile width) forced to each choice in turn, then restored."""
    keep = getattr(kernel, attr)
    out = {}
    try:
        for choice in choices:
            setattr(kernel, attr, choice)
            out[str(choice)] = measure()
    finally:
        setattr(kernel, attr, keep)
    return out


# widths around B1's warps and B2's tiles, and the Fp12 width at 128 lanes
RAGGED = (1, 7, 31, 33, 63, 65, 127, 129, 4099, 54 * 2 * 128)


def ragged_phase(cios_fields, rns_fields, rng) -> dict:
    """B1 (every lanes-per-column instance and the wrapper's own choice) and
    B2 (every tile width) against their plain versions, exactly, at each
    RAGGED width: on contiguous operands, and on a row slice of a wider
    array at a column offset of 3, whose rows are not 16-byte aligned (B2's
    4-byte copies). Returns {kernel/rows: widths checked}. Raises on any
    difference."""
    import torch

    from handel_tpu_torch.kernels.fp_mont import TPI_CHOICES, mont_mul
    from handel_tpu_torch.kernels.rns_mont import TILES, rns_mul_resident

    def check(name, F, fn, plain, full_a, full_b, kernel, attr, choices):
        cols = full_a.shape[1] - 3
        a, b = full_a[:, :cols].contiguous(), full_b[:, :cols].contiguous()
        sliced = full_a[:, 3:]
        want, want_sliced = plain(a, b), plain(sliced, b)
        got = each_instance(kernel, attr, (getattr(kernel, attr), *choices),
                            lambda: (fn(a, b), fn(sliced, b)))
        for choice, (g, gs) in got.items():
            if not (torch.equal(g, want) and torch.equal(gs, want_sliced)):
                raise AssertionError(f"{name} != plain at {cols} columns ({attr} {choice})")

    out = {}
    for F in cios_fields:
        for cols in RAGGED:
            a, b = operand_pair(F, cols + 3, rng, with_edges=cols >= 16)
            check("B1", F, F.mul, F._mul_plain, a.to(F.device), b.to(F.device),
                  mont_mul, "tpi", TPI_CHOICES)
        out[f"fp_mont_mul/{F.nlimbs}"] = list(RAGGED)
    for F in rns_fields:
        for cols in RAGGED:
            a = random_residues(F, cols + 3, rng).to(F.device)
            b = random_residues(F, cols + 3, rng).to(F.device)
            check("B2", F, F.mul_resident, F._mul_resident_core, a, b,
                  rns_mul_resident, "tile", TILES)
        out[f"rns_mont_mul_resident/{F.k_all}"] = list(RAGGED)
    torch.cuda.synchronize()
    line("ragged", checked=out, unaligned_offset=3, max_abs_err=0)
    return out


def kernel_phase(F, widths: dict[str, int], rng, with_edges: bool) -> dict:
    """Kernel against the plain version on the card at each width; returns
    per-width figures. Raises on any difference."""
    import torch

    from handel_tpu_torch.kernels.fp_mont import TPI_CHOICES, lanes_for, mont_mul

    dev = F.device
    out = {}
    for label, cols in widths.items():
        a, b = operand_pair(F, cols, rng, with_edges)
        a, b = a.to(dev), b.to(dev)
        before = mont_mul.launches
        got = F.mul(a, b)
        if mont_mul.launches != before + 1:
            raise AssertionError("Field.mul on CUDA tensors did not launch the kernel")
        want = F._mul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at n={F.nlimbs} width {label}: max err {err}")
        # the plain version itself against Python integers on a prefix
        k = min(cols, 256)
        rinv = pow(F.mont_r, -1, F.p)
        xs, ys = F.unpack(a[:, :k], mont=False), F.unpack(b[:, :k], mont=False)
        if F.unpack(got[:, :k], mont=False) != [x * y * rinv % F.p for x, y in zip(xs, ys)]:
            raise AssertionError(f"kernel != integer oracle at n={F.nlimbs} width {label}")
        launches = mont_mul.launches - before
        if label == next(iter(widths)):
            replay_check(F.mul, a, b, mont_mul)
        ms = graph_ms(F.mul, a, b)
        eager_ms = cuda_ms(lambda: F.mul(a, b), 20 if cols <= 1 << 20 else 5)
        plain_ms = cuda_ms(lambda: F._mul_plain(a, b), 3)
        bound, bound_by = mont_mul_bound_ms(F.nlimbs, cols)
        out[label] = dict(
            nlimbs=F.nlimbs, cols=cols, max_abs_err=err, ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, launches=launches,
            tpi=lanes_for(cols),
            ms_by_tpi=each_instance(mont_mul, "tpi", TPI_CHOICES, lambda: graph_ms(F.mul, a, b)),
        )
        line("kernel", **out[label], width=label)
        del a, b, got, want
        torch.cuda.empty_cache()
    return out


def lab_kernel_phase(F, widths: dict[str, int], rng, timed=()) -> dict:
    """Kernels B3a and B3b, every instance (warps per block), against their
    plain bodies and against B1 on the card at each width (canonical
    operands led by the edge pairs), and against their plain bodies on the
    lab's own race inputs (2^18 columns of raw 16-bit digits, values up to
    R - 1), exact. At each width the default instance's device time, eager
    time and the plain body's; at the widths in `timed` every instance's
    device time too (`ms_by_instance`). Returns {kernel: {width/nlimbs:
    figures}}. Raises on any difference."""
    import torch

    from handel_tpu_torch.kernels.lab_mont import (
        DEFAULT_WARPS,
        WARPS,
        lab_cios_fullwidth,
        lab_separated,
    )
    from handel_tpu_torch.scripts.fp_kernel_lab import LabField, raw_operands

    lab = LabField(F)
    dev = F.device
    forms = (("lab_cios_fullwidth", lab_cios_fullwidth, "cios_fullwidth"),
             ("lab_separated", lab_separated, "separated"))
    out = {"lab_cios_fullwidth": {}, "lab_separated": {}}

    def launch(name, counter, fn, a, b):
        before = counter.launches
        got = fn(a, b)
        if counter.launches != before + 1:
            raise AssertionError(f"{name} on CUDA tensors did not launch its kernel")
        return got

    # raw digits reach the code that drops what passes the top
    ra, rb = raw_operands(F, 1 << 18)
    for name, counter, form in forms:
        want = lab.body(form)(ra, rb)
        for warps in WARPS:
            got = launch(name, counter, lab.kernel(form, warps), ra, rb)
            err = int((got.long() - want.long()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} w{warps} != plain on raw digits at n={F.nlimbs}: max err {err}")
        out[name][f"raw_digits/{F.nlimbs}"] = fig = dict(
            nlimbs=F.nlimbs, cols=ra.shape[1], max_abs_err=err, instances=list(WARPS))
        line("lab_kernel", kernel=name, width="raw_digits", **fig)
    del ra, rb, got, want
    for label, cols in widths.items():
        a, b = operand_pair(F, cols, rng, True)
        a, b = a.to(dev), b.to(dev)
        b1 = F.mul(a, b)
        for name, counter, form in forms:
            body = lab.body(form)
            want = body(a, b)
            for warps in WARPS:
                got = launch(name, counter, lab.kernel(form, warps), a, b)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max().item())
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name} w{warps} != plain at n={F.nlimbs} width {label}: max err {err}")
                if not torch.equal(got, b1):
                    raise AssertionError(f"{name} w{warps} != B1 at n={F.nlimbs} width {label}")
            fn = lab.kernel(form)
            if label == next(iter(widths)):
                replay_check(fn, a, b, counter)
            ms = graph_ms(fn, a, b)
            by_instance = ({f"w{w}": (ms if w == DEFAULT_WARPS
                                      else graph_ms(lab.kernel(form, w), a, b))
                            for w in WARPS} if label in timed else None)
            eager_ms = cuda_ms(lambda: fn(a, b), 20)
            plain_ms = cuda_ms(lambda: body(a, b), 3)
            bound, bound_by = mont_mul_bound_ms(F.nlimbs, cols)
            out[name][f"{label}/{F.nlimbs}"] = fig = dict(
                nlimbs=F.nlimbs, cols=cols, max_abs_err=err, matches_b1=True, ms=ms,
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                instance=f"w{DEFAULT_WARPS}", ms_by_instance=by_instance,
            )
            line("lab_kernel", kernel=name, width=label, **fig)
        del a, b, b1, got, want
        torch.cuda.empty_cache()
    return out


def sass_profile(lib) -> dict[str, dict[str, int]] | None:
    """{kernel<template args>: {"instructions": n, "IMMA": n, "IDP": n}} in a
    built library's SASS (cuobjdump -sass): every instruction but the NOPs
    that pad the code, and the integer tensor-core (IMMA) and dot-product
    (IDP, __dp4a) ones among them. In a kernel without loops, where a
    thread owns one column, `instructions` is what one column issues: each
    thread-instruction once, a warp-wide mma.sync once for each of its 32
    columns' lanes. None when the toolkit has no cuobjdump."""
    from pathlib import Path

    from handel_tpu_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {"instructions": 0, "IMMA": 0, "IDP": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if cur is None or not m or m.group(1) == "NOP":
            continue
        cur["instructions"] += 1
        if m.group(1) in ("IMMA", "IDP"):
            cur[m.group(1)] += 1
    return out


def lab_phase(dev, counters) -> dict:
    """The lab entry points as one main-path run: every kernel count set to
    0 just before, read just after. fp_kernel_lab at its batch 2^18,
    mxu_limb_lab at its batch 2^15, and the production field's marginal
    rate for cios and rns at 2^20. A failed validation or agreement gate
    exits there (SystemExit) and fails the run. Returns the figures."""
    from handel_tpu_torch.ops.fp import _throughput_bench
    from handel_tpu_torch.scripts import fp_kernel_lab, mxu_limb_lab

    zero_counts(counters)
    t0 = time.perf_counter()
    batch = 1 << 18
    labs = {f"fp_kernel_lab/{batch}": fp_kernel_lab.main([str(batch)])}
    labs["mxu_limb_lab"] = mxu_limb_lab.main([])
    rates = {backend: _throughput_bench(1 << 20, backend=backend, device=dev)[0]
             for backend in ("cios", "rns")}
    launches = {k: c.launches for k, c in counters.items()}
    seconds = time.perf_counter() - t0
    for key, res in labs.items():
        if res["lab"] == "fp_kernel_lab":
            line("lab", lab=key, batch=res["batch"], muls_per_s=res["muls_per_s"],
                 replayed_calls=res["replayed_calls"],
                 max_memory_allocated=res["max_memory_allocated"])
            if any(v is None for v in res["muls_per_s"].values()):
                raise AssertionError(f"{key}: a candidate's slope was not measurable")
        else:
            line("lab", lab=key, **{k: v for k, v in res.items() if k not in ("lab", "device")})
            if any(res[k] is None for k in ("prod_muls_per_s", "outer8_muls_per_s", "rns_muls_per_s")):
                raise AssertionError(f"{key}: a candidate's slope was not measurable")
    line("lab", lab="ops.fp", batch=1 << 20, mont_muls_per_s=rates)
    if not all(rates.values()):
        raise AssertionError(f"ops.fp: a marginal rate was not measurable: {rates}")
    if launches["rns_mont_mul_resident"] != 0:
        raise AssertionError("the lab launched B2: the per-mul rns product never does")
    # the kernels B3a and B3b executed: a wrapper's count moves at eager calls
    # and at graph capture, never at replay, so take the captured calls out
    # and the replayed ones in
    captured, replayed, executed = {}, {}, {}
    for name, form in (("lab_cios_fullwidth", "cios_fullwidth"), ("lab_separated", "separated")):
        cands = [(res, cand) for key, res in labs.items() if key.startswith("fp_kernel_lab")
                 for cand in res["replayed_calls"] if cand.startswith(f"cuda:{form}:")]
        captured[name] = sum(res["captured_calls"][cand] for res, cand in cands)
        replayed[name] = sum(res["replayed_calls"][cand] for res, cand in cands)
        executed[name] = launches[name] - captured[name] + replayed[name]
        if executed[name] == 0:
            raise AssertionError(f"the lab never launched {name}")
    line("memory", path="lab", wrapper_counts=launches, captured_calls=captured,
         replayed_calls=replayed, executed=executed, seconds=seconds)
    return {"labs": labs, "rates": rates, "executed": executed, "captured": captured,
            "replayed": replayed}


# A curve family is its engine class (BN254Device, BLS12381Device): the
# class binds the scalar oracle `ref`, `Curves`, `Pairing`, `_hash_to_g1`
# and the host `PublicKey` and `Signature` types.


def make_registry(n: int, rng: random.Random, family):
    """Registry keys of `family`'s curve from seeded small scalars
    (bench.py's and scripts/bench_bls12.py's keygen shape: device cost does
    not depend on the scalar size)."""
    ref = family.ref
    sks = [rng.randrange(1, 1 << 30) for _ in range(n)]
    return sks, [family.PublicKey(ref.g2_mul(ref.G2_GEN, s)) for s in sks]


def make_requests(kind: str, sks, count: int, rng: random.Random, family, msg: bytes = MSG,
                  honest: bool = False, max_holes: int = 8):
    """`count` candidates of one launch class of `family`'s curve on `msg`
    with the verdict each must get.

    range: contiguous partitioner ranges of n/8, n/4 or n/2 keys with up to
    `max_holes` holes (bench.py build_problem); dense: random quarter
    subsets (bench.py's dense phase). Unless `honest`, lane 1 carries a
    wrong signature, lane 2 a signature over another message, lane 3 an
    empty bitset."""
    from handel_tpu_torch.core.bitset import BitSet

    ref = family.ref
    n = len(sks)
    h, h_other = family._hash_to_g1(msg), family._hash_to_g1(msg + b" (other)")
    forged = () if honest else (1, 2, 3)
    requests, expect = [], []
    for j in range(count):
        if kind == "range":
            size = rng.choice([n // 8, n // 4, n // 2])
            lo = rng.randrange(0, n - size)
            holes = set(rng.sample(range(lo, lo + size), rng.randrange(0, max_holes + 1)))
            signers = [i for i in range(lo, lo + size) if i not in holes]
        else:
            signers = rng.sample(range(n), n // 4)
        lane = j if j in forged else None
        if lane == 3:
            signers = []
        bs = BitSet(n)
        for i in signers:
            bs.set(i, True)
        agg = sum(sks[i] for i in signers) % ref.R
        point = ref.g1_mul(h_other if lane == 2 else h, agg + (1 if lane == 1 else 0))
        requests.append((bs, family.Signature(point)))
        expect.append(j not in forged)
    return requests, expect


def pairing_phase(device, backend: str, family, curves=None) -> None:
    """e(P, Q) on the card against the scalar oracle of `family`'s curve on
    two lanes (the resident pairing for the rns backend), over `curves` when
    given."""
    ref, name = family.ref, family.__name__
    pr = family.Pairing(curves or family.Curves(device=device, backend=backend))
    if pr.resident != (backend == "rns") or pr.F.backend != backend:
        raise AssertionError(f"{name} {backend} pairing resident={pr.resident}")
    F, T = pr.F, pr.T
    rng = random.Random(SEED)
    ps = [ref.g1_mul(ref.G1_GEN, rng.randrange(1, ref.R)) for _ in range(2)]
    qs = [ref.g2_mul(ref.G2_GEN, rng.randrange(1, ref.R)) for _ in range(2)]
    p = (F.pack([x[0] for x in ps]), F.pack([x[1] for x in ps]))
    q = (T.f2_pack([x[0] for x in qs]), T.f2_pack([x[1] for x in qs]))
    if T.f12_unpack(pr.pairing(p, q)) != [ref.pairing(b, a) for a, b in zip(ps, qs)]:
        raise AssertionError(f"{name} {backend} pairing on the card != scalar oracle")
    line("pairing", family=name, backend=backend, resident=pr.resident, lanes=2,
         matches_oracle=True)


def profile_phase(cons, pks, requests, kernel: str, label: str, counter, bound) -> dict:
    """One verify launch under torch.profiler (device activity only): the
    kernels and copies it ran, the device's busy time against the wall time
    (the idle share, inflated by the profiler's own host cost), and the
    activities that took the most device time. For the path's kernel
    (`kernel` in its device name, `counter` its wrapper): its device ms in
    the launch against the sum of bound(cols) over the launch's calls, from
    the wrapper's width histogram. Returns the kernel's figures."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(counter.widths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cons.batch_verify(MSG, pks, requests)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the profiler's raw records (name, device ms): its parsed event list
    # costs about 95 s of host time for the two paths' 700,000 records
    acts = [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    if not acts:
        raise AssertionError("torch.profiler recorded no device activity")
    by_name: dict[str, list] = {}
    for name, ms in acts:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += ms
    busy_ms = sum(ms for _, ms in by_name.values())
    ours = [v for k, v in by_name.items() if kernel in k]
    if not ours:
        raise AssertionError(f"the profiled launch ran no {kernel}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    calls = {cols: n - before.get(cols, 0) for cols, n in counter.widths.items()
             if n != before.get(cols, 0)}
    fig = {"count": sum(c for c, _ in ours), "ms": sum(ms for _, ms in ours),
           "calls_by_cols": {str(k): v for k, v in sorted(calls.items())},
           "bound_ms": sum(n * bound(cols)[0] for cols, n in calls.items())}
    line("profile", path=label, launch_class="range", wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
         device_activities=len(acts), **{kernel: fig},
         top=[{"name": k[:80], "count": c, "ms": ms} for k, (c, ms) in top])
    return fig


def zero_counts(counters) -> None:
    """Every kernel's launch count to 0, and B1's and B2's width histograms
    with it."""
    for c in counters.values():
        if hasattr(c, "reset"):
            c.reset()
        else:
            c.launches = 0


def width_histograms(counters) -> dict:
    """{kernel: {columns: launches}} for the wrappers that count widths and
    launched in the run."""
    return {k: {str(cols): n for cols, n in sorted(c.widths.items())}
            for k, c in counters.items() if getattr(c, "widths", None)}


def verify_path(label, cons, pks, reqs, counters, expect_launch, expect_idle, conv_field=None):
    """One main-path run of a verify path: prepare (registry commit, warmup
    and prefix table), then every kernel count set to 0, the range and dense
    launches with their verdicts checked, the counts read; then the timed
    launches, whose walls join the main-path launch's. Returns ({kernel:
    launches in the main-path run}, {launch class: p50 wall ms})."""
    import torch

    dev = cons.curves.device
    t0 = time.perf_counter()
    engine = cons.prepare(pks)  # registry commit + warmup launch (prefix table)
    torch.cuda.synchronize()
    line("prepare", path=label, seconds=time.perf_counter() - t0)
    for kind, (requests, _expect) in reqs.items():
        plan = engine._pack_requests(requests)
        if plan.kind != kind:
            raise AssertionError(f"{kind} requests packed as a {plan.kind} launch")

    # the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    if conv_field is not None:
        conv_field.reset_conversion_counts()
    per_class, walls = {}, {}
    for kind, (requests, expect) in reqs.items():
        before = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        got = cons.batch_verify(MSG, pks, requests)
        walls[kind] = [(time.perf_counter() - t0) * 1e3]
        per_class[kind] = {k: c.launches - before[k] for k, c in counters.items()}
        if got != expect:
            bad = [j for j, (g, e) in enumerate(zip(got, expect)) if g != e]
            raise AssertionError(f"{label} {kind} verdicts wrong at lanes {bad}")
    launches = {k: c.launches for k, c in counters.items()}
    widths = width_histograms(counters)
    conv = conv_field.conversion_counts() if conv_field is not None else None
    if launches[expect_launch] == 0:
        raise AssertionError(f"the {label} path never launched {expect_launch}")
    for k in expect_idle:
        if launches[k] != 0:
            raise AssertionError(f"the {label} path launched {k} {launches[k]} times")
    peak = torch.cuda.max_memory_allocated(dev)
    for kind, (requests, _expect) in reqs.items():
        for _ in range(TIMED_LAUNCHES):
            t0 = time.perf_counter()
            cons.batch_verify(MSG, pks, requests)
            walls[kind].append((time.perf_counter() - t0) * 1e3)
        line("verify", path=label, launch_class=kind, lanes=LANES,
             candidates=len(requests), registry=N_REGISTRY, verdicts_ok=True,
             p50_ms=statistics.median(walls[kind]), wall_ms=walls[kind],
             launches_per_verify=per_class[kind])
    line("memory", path=label, max_memory_allocated=peak, launches=launches,
         conversion_counts=conv)
    line("widths", path=label, launches_by_cols=widths)
    return launches, {kind: statistics.median(w) for kind, w in walls.items()}


def round_phase(dev, counters) -> dict:
    """A Handel round on `dev` through the port's own harness (phase 7).

    The engine is prepared first (registry commit, warmup launch, combine
    classes 2, 4 and 8); then every count is zeroed, the nodes start, the
    forged candidate goes to node 0, and the round runs to complete
    success. The constructor's `batch_verify` and `device_combine` record
    any exception they raise and stop the nodes: the processing loop would
    requeue a candidate whose launch failed, so the round fails on the
    first recorded one instead.
    Raises on any failed check; returns the round's figures."""
    import asyncio

    import torch

    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.core.crypto import MultiSignature, verify_multisignature
    from handel_tpu_torch.core.net import Packet
    from handel_tpu_torch.core.test_harness import LocalCluster
    from handel_tpu_torch.core.trace import LogHistogram
    from handel_tpu_torch.models.bn254 import BN254SecretKey
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme

    t0 = time.perf_counter()
    scheme = BN254TorchScheme(batch_size=LANES, device=dev)
    failures: list[BaseException] = []

    def recorded(fn):
        def call(*args, **kw):
            try:
                return fn(*args, **kw)
            except BaseException as e:
                failures.append(e)
                # a node's processing loop holds the event loop while its
                # queue has candidates: stopping every node lets the
                # watcher run now instead of when the round ends
                cluster.stop()
                raise
        return call

    # set before the cluster exists: each node's CombineShim binds
    # `device_combine` when its Handel is built
    cons = scheme.constructor
    cons.batch_verify = recorded(cons.batch_verify)
    cons.device_combine = recorded(cons.device_combine)
    cluster = LocalCluster(ROUND_NODES, scheme=scheme, msg=MSG)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheme.constructor.prepare(cluster.registry.public_keys())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    prepare_s = time.perf_counter() - t0

    h0 = cluster.handels[0]
    (peer,) = h0.partitioner.identities_at(1)
    one = BitSet(1)
    one.set(0, True)
    forged = Packet(origin=peer.id, level=1, multisig=MultiSignature(
        one, BN254SecretKey(FORGER_SCALAR).sign(MSG)).marshal())

    async def go():
        async def watch():
            while not failures:
                await asyncio.sleep(0.25)

        zero_counts(counters)
        t_start = time.perf_counter()
        cluster.start()
        h0.new_packet(forged)
        done = asyncio.ensure_future(cluster.wait_complete_success(timeout=ROUND_TIMEOUT_S))
        watcher = asyncio.ensure_future(watch())
        try:
            await asyncio.wait([done, watcher], return_when=asyncio.FIRST_COMPLETED)
            if failures:
                raise AssertionError(
                    f"a device launch failed in the round: {failures[0]!r}"
                ) from failures[0]
            return done.result(), time.perf_counter() - t_start
        finally:
            done.cancel()
            watcher.cancel()
            cluster.stop()
            await asyncio.gather(done, watcher, return_exceptions=True)

    results, wall_s = asyncio.run(go())
    launches = {k: c.launches for k, c in counters.items()}
    widths = width_histograms(counters)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    t0 = time.perf_counter()
    if sorted(results) != list(range(ROUND_NODES)):
        raise AssertionError(f"final signatures from nodes {sorted(results)} only")
    verified: dict[bytes, bool] = {}
    for i, sig in results.items():
        if sig.cardinality() < cluster.threshold:
            raise AssertionError(f"node {i}: {sig.cardinality()} < threshold {cluster.threshold}")
        wire = sig.marshal()
        if wire not in verified:
            verified[wire] = verify_multisignature(MSG, sig, cluster.registry, scheme.constructor)
        if not verified[wire]:
            raise AssertionError(f"node {i}'s final signature does not verify")
    host_check_s = time.perf_counter() - t0
    values = [h.values() for h in cluster.handels.values()]
    total = lambda key: sum(v[key] for v in values)  # noqa: E731
    hist = LogHistogram()
    for h in cluster.handels.values():
        hist.merge(h.proc.hist_verify)
    fig = {
        "nodes": ROUND_NODES, "lanes": LANES, "threshold": cluster.threshold,
        "wall_s": wall_s, "keygen_s": keygen_s, "prepare_s": prepare_s,
        "host_check_s": host_check_s,
        "final_cardinalities": [results[i].cardinality() for i in sorted(results)],
        "verify_launches": hist.count,
        "verify_candidates": int(total("sigCheckedCt") - total("dedupHits")),
        "verify_p50_s": hist.quantile(0.5), "verify_mean_s": hist.sum / max(1, hist.count),
        "verify_min_s": hist.lo, "verify_max_s": hist.hi,
        "combine_device_groups": int(total("combineDeviceGroups")),
        "combine_host_groups": int(total("combineHostGroups")),
        "combine_groups": int(total("combineGroups")),
        "combine_points": int(total("combinePoints")),
        "sig_verify_failed": int(total("sigVerifyFailed")),
        "kernel_launches": launches, "widths": widths.get("fp_mont_mul", {}),
        "max_memory_allocated": peak,
    }
    line("round", **fig)
    if fig["sig_verify_failed"] < 1:
        raise AssertionError("the forged candidate was never rejected by a device verdict")
    if fig["combine_device_groups"] < 1:
        raise AssertionError("no merge of the round reached the device combine")
    if launches["fp_mont_mul"] == 0:
        raise AssertionError("the round never launched B1")
    for k in ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"):
        if launches[k] != 0:
            raise AssertionError(f"the round launched {k} {launches[k]} times")
    return fig



class LaneCalls:
    """Wraps the engine calls a service makes on worker threads — its
    `dispatch_multi` (the service's launch entry when the engine has it)
    and `fetch` — to record each call's start and end, under "dispatch"
    and "fetch", and the first exception either raises; `on_error` then
    runs on the event loop. `restore()` puts the engine's own methods
    back."""

    ENTRIES = {"dispatch": "dispatch_multi", "fetch": "fetch"}

    def __init__(self, engine, on_error=None):
        import threading

        self.engine, self.on_error = engine, on_error
        self.spans: dict[str, list[tuple[float, float]]] = {"dispatch": [], "fetch": []}
        self.failures: list[BaseException] = []
        self.loop = None
        self._lock = threading.Lock()
        for name, attr in self.ENTRIES.items():
            setattr(engine, attr, self._wrap(name, getattr(engine, attr)))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            except BaseException as e:
                with self._lock:
                    self.failures.append(e)
                if self.on_error is not None and self.loop is not None:
                    self.loop.call_soon_threadsafe(self.on_error)
                raise
            finally:
                with self._lock:
                    self.spans[name].append((t0, time.perf_counter()))
        return call

    def restore(self) -> None:
        for attr in self.ENTRIES.values():
            delattr(self.engine, attr)

    def overlap_s(self) -> float:
        """Seconds in which a dispatch and a fetch were in flight together."""
        def union(spans):
            out = []
            for a, b in sorted(spans):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            return out

        d, f = union(self.spans["dispatch"]), union(self.spans["fetch"])
        return sum(max(0.0, min(b1, b2) - max(a1, a2)) for a1, b1 in d for a2, b2 in f)


def service_checks(label: str, values: dict) -> None:
    """No failover, no retry, the breaker closed: nothing hid the device."""
    for key in ("failoverBatches", "failoverCandidates", "deviceRetryCt"):
        if values[key] != 0:
            raise AssertionError(f"{label}: {key} = {values[key]}")
    if values["breakerState"] != 0.0:
        raise AssertionError(f"{label}: breaker not closed ({values['breakerState']})")


def service_load_phase(cons, pks, sks, counters, prng) -> dict:
    """Phase 8a: SERVICE_SESSIONS sessions of range candidates at once
    through one service over the prepared engine of `cons`, as one
    main-path run. Raises on any failed check; returns the figures."""
    import asyncio

    import torch

    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

    engine = cons._device
    dev = engine.device
    batches = [make_requests("range", sks, RANGE_CANDIDATES, prng, cons.Device)
               for _ in range(SERVICE_SESSIONS)]
    calls = LaneCalls(engine)
    svc = BatchVerifierService(engine, fallback=None, max_inflight=2)
    engine.reset_host_counters()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    async def go():
        calls.loop = asyncio.get_running_loop()
        try:
            return await asyncio.gather(*(
                svc.verify(MSG, pks, reqs, session=f"s{i}") for i, (reqs, _) in enumerate(batches)
            ))
        finally:
            svc.stop()

    zero_counts(counters)
    t0 = time.perf_counter()
    try:
        got = asyncio.run(go())
    finally:
        calls.restore()
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    widths = width_histograms(counters)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    values = svc.values()
    candidates = sum(len(reqs) for reqs, _ in batches)
    fig = {
        "sessions": SERVICE_SESSIONS, "candidates": candidates, "lanes": LANES,
        "registry": len(pks), "wall_s": wall_s, "candidates_per_s": candidates / wall_s,
        "launches": values["verifierLaunches"], "launch_fill": values["launchFillRatio"],
        "host_pack_ms_per_launch": values["hostPackMsPerLaunch"],
        "host_dispatch_ms_per_launch": values["hostDispatchMsPerLaunch"],
        "dispatch_s": [b - a for a, b in calls.spans["dispatch"]],
        "fetch_s": [b - a for a, b in calls.spans["fetch"]],
        "dispatch_fetch_overlap_s": calls.overlap_s(),
        "kernel_launches": launches, "widths": widths, "max_memory_allocated": peak,
    }
    line("service", run="load", **fig)
    for i, (verdicts, (_reqs, expect)) in enumerate(zip(got, batches)):
        if verdicts != expect:
            bad = [j for j, (g, e) in enumerate(zip(verdicts, expect)) if g != e]
            raise AssertionError(f"service load: session s{i} verdicts wrong at lanes {bad}")
    if values["verifierLaunches"] not in (2.0, 3.0):
        raise AssertionError(f"service load: {values['verifierLaunches']} launches, not 2 or 3")
    if values["launchFillRatio"] < 0.6:
        raise AssertionError(f"service load: launch fill {values['launchFillRatio']} < 0.6")
    service_checks("service load", values)
    if launches["fp_mont_mul"] == 0:
        raise AssertionError("the service load never launched B1")
    for k in ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"):
        if launches[k] != 0:
            raise AssertionError(f"the service load launched {k} {launches[k]} times")
    return fig


def service_round_phase(dev, counters, fp_backend: str, label: str, expect_launch: str,
                        expect_idle, nodes: int = SERVICE_ROUND_NODES) -> dict:
    """Phase 8b: a Handel round of `nodes` nodes through the port's harness, every node verifying through one service over the
    constructor's prepared engine, as one main-path run. Raises on any failed check;
    returns the round's figures."""
    import asyncio

    import torch

    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.core.config import Config
    from handel_tpu_torch.core.crypto import MultiSignature, verify_multisignature
    from handel_tpu_torch.core.net import Packet
    from handel_tpu_torch.core.test_harness import LocalCluster
    from handel_tpu_torch.core.timeout import InfiniteTimeout
    from handel_tpu_torch.core.trace import LogHistogram
    from handel_tpu_torch.models.bn254 import BN254SecretKey
    from handel_tpu_torch.models.bn254_torch import BN254TorchScheme
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

    t0 = time.perf_counter()
    scheme = BN254TorchScheme(batch_size=LANES, device=dev, fp_backend=fp_backend)
    cons = scheme.constructor
    failures: list[BaseException] = []
    svc = None

    def combine_recorded(fn):
        def call(*args, **kw):
            try:
                return fn(*args, **kw)
            except BaseException as e:
                failures.append(e)
                cluster.stop()  # the event loop's own thread: stop at once
                raise
        return call

    async def verify(msg, pubkeys, requests):
        return await svc.verify(msg, pubkeys, requests)

    def factory(i):
        c = Config()
        c.verifier = verify
        c.new_timeout = InfiniteTimeout  # what the harness sets without a factory
        c.rand = random.Random(1 + i)
        return c

    # set before the cluster exists: each node's CombineShim binds
    # `device_combine` when its Handel is built
    cons.device_combine = combine_recorded(cons.device_combine)
    cluster = LocalCluster(nodes, scheme=scheme, msg=MSG, config_factory=factory)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = cons.prepare(cluster.registry.public_keys())  # warmup, then a device synchronize
    prepare_s = time.perf_counter() - t0
    calls = LaneCalls(engine, on_error=cluster.stop)
    svc = cluster.verifier_service = BatchVerifierService(engine, fallback=None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    h0 = cluster.handels[0]
    (peer,) = h0.partitioner.identities_at(1)
    one = BitSet(1)
    one.set(0, True)
    forged = Packet(origin=peer.id, level=1, multisig=MultiSignature(
        one, BN254SecretKey(FORGER_SCALAR).sign(MSG)).marshal())

    async def go():
        calls.loop = asyncio.get_running_loop()

        async def watch():
            while not (failures or calls.failures):
                await asyncio.sleep(0.25)

        zero_counts(counters)
        t_start = time.perf_counter()
        cluster.start()
        h0.new_packet(forged)
        done = asyncio.ensure_future(cluster.wait_complete_success(timeout=ROUND_TIMEOUT_S))
        watcher = asyncio.ensure_future(watch())
        try:
            await asyncio.wait([done, watcher], return_when=asyncio.FIRST_COMPLETED)
            first = (failures or calls.failures or [None])[0]
            if first is not None:
                raise AssertionError(
                    f"a device call failed in the {label} round: {first!r}") from first
            return done.result(), time.perf_counter() - t_start
        finally:
            done.cancel()
            watcher.cancel()
            cluster.stop()
            svc.stop()
            await asyncio.gather(done, watcher, return_exceptions=True)

    try:
        results, wall_s = asyncio.run(go())
    finally:
        calls.restore()
    launches = {k: c.launches for k, c in counters.items()}
    widths = width_histograms(counters)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    values = svc.values()

    t0 = time.perf_counter()
    if sorted(results) != list(range(nodes)):
        raise AssertionError(f"{label}: final signatures from {len(results)} nodes only")
    verified: dict[bytes, bool] = {}
    for i, sig in results.items():
        if sig.cardinality() < cluster.threshold:
            raise AssertionError(
                f"{label}: node {i}: {sig.cardinality()} < threshold {cluster.threshold}")
        wire = sig.marshal()
        if wire not in verified:
            verified[wire] = verify_multisignature(MSG, sig, cluster.registry, cons)
        if not verified[wire]:
            raise AssertionError(f"{label}: node {i}'s final signature does not verify")
    host_check_s = time.perf_counter() - t0
    node_values = [h.values() for h in cluster.handels.values()]
    total = lambda key: sum(v[key] for v in node_values)  # noqa: E731
    hist = LogHistogram()
    for h in cluster.handels.values():
        hist.merge(h.proc.hist_verify)
    fig = {
        "backend": fp_backend, "nodes": nodes, "lanes": LANES,
        "threshold": cluster.threshold,
        "wall_s": wall_s, "keygen_s": keygen_s, "prepare_s": prepare_s,
        "host_check_s": host_check_s, "distinct_finals": len(verified),
        "min_final_cardinality": min(s.cardinality() for s in results.values()),
        "launches": values["verifierLaunches"], "candidates": values["verifierCandidates"],
        "launch_fill": values["launchFillRatio"], "dedup_hits": values["dedupHits"],
        "dedup_hit_rate": values["dedupHitRate"],
        "node_verify_calls": hist.count, "node_verify_p50_s": hist.quantile(0.5),
        "node_verify_mean_s": hist.sum / max(1, hist.count),
        "node_verify_max_s": hist.hi,
        "host_pack_ms_per_launch": values["hostPackMsPerLaunch"],
        "host_dispatch_ms_per_launch": values["hostDispatchMsPerLaunch"],
        "dispatch_s": [b - a for a, b in calls.spans["dispatch"]],
        "dispatch_fetch_overlap_s": calls.overlap_s(),
        "combine_device_groups": int(total("combineDeviceGroups")),
        "combine_host_groups": int(total("combineHostGroups")),
        "sig_verify_failed": int(total("sigVerifyFailed")),
        "kernel_launches": launches, "widths": widths, "max_memory_allocated": peak,
    }
    line("service", run=label, **fig)
    if fig["sig_verify_failed"] < 1:
        raise AssertionError(
            f"{label}: the forged candidate was never rejected by a device verdict")
    if fig["combine_device_groups"] < 1:
        raise AssertionError(f"{label}: no merge of the round reached the device combine")
    if not 0 < values["verifierLaunches"] < nodes:
        raise AssertionError(
            f"{label}: {values['verifierLaunches']} launches for {nodes} nodes")
    if values["dedupHits"] < 1:
        raise AssertionError(f"{label}: the service deduplicated nothing")
    service_checks(label, values)
    if launches[expect_launch] == 0:
        raise AssertionError(f"the {label} run never launched {expect_launch}")
    for k in expect_idle:
        if launches[k] != 0:
            raise AssertionError(f"the {label} run launched {k} {launches[k]} times")
    return fig


def kernel_lines(workdir: str, prefix: str, phase: str) -> dict[str, dict]:
    """{file: `node process kernels` JSON} of a run dir's node process
    outputs; each must also say `finished OK`."""
    out = {}
    for name in sorted(os.listdir(workdir)):
        if not (name.startswith(prefix) and name.endswith(".out")):
            continue
        with open(os.path.join(workdir, name)) as f:
            text = f.read()
        if "node process finished OK" not in text:
            raise AssertionError(f"{phase}: {name} has no `finished OK` line:\n{text[-3000:]}")
        (out[name],) = [json.loads(ln.split(": ", 1)[1]) for ln in text.splitlines()
                        if ln.startswith("node process kernels: ")]
    return out


def sim_env(root: Path) -> dict:
    """The environment of a sim subprocess: the card, and the checkout first
    on the import path."""
    return dict(os.environ, HANDEL_TORCH_DEVICE="cuda",
                PYTHONPATH=os.pathsep.join(
                    [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))


@contextlib.contextmanager
def sim_run(phase: str, config: str, changes: dict, run_changes: dict, limit_s: float,
            during=None):
    """Runs the port's sim CLI on `config` with `changes` set on the config
    and `run_changes` on its first run, in a subprocess of its own process
    group, so that `limit_s` stops the node processes too. `during(tmp,
    proc, deadline)`, when given, runs while the sim does and its result is
    `live`. Raises on a timeout, a non-zero exit, a missing success line,
    a node process without its `finished OK` and `kernels` lines, or a
    node process count other than the run's. Yields, with the run's
    directory still in place: cfg, run, tmp, out, err, logs ({node output
    file: text}), processes ({node .out file: kernels line}), header, col
    (the CSV's first row by column), wall_s, live."""
    from handel_tpu_torch.sim.config import dump_config, load_config

    root = Path(__file__).resolve().parent
    cfg = load_config(str(root / config))
    for key, value in changes.items():
        setattr(cfg, key, value)
    run = cfg.runs[0]
    for key, value in run_changes.items():
        target = run
        *path, name = key.split(".")
        for part in path:
            target = getattr(target, part)
        setattr(target, name, value)
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase}_") as tmp:
        cfg_path = os.path.join(tmp, "sim.toml")
        with open(cfg_path, "w") as f:
            f.write(dump_config(cfg))
        cmd = [sys.executable, "-m", "handel_tpu_torch.sim", "--config", cfg_path,
               "--workdir", tmp]
        t0 = time.perf_counter()
        deadline = time.monotonic() + limit_s
        live = None
        with open(os.path.join(tmp, "sim.out"), "w") as out_f, \
                open(os.path.join(tmp, "sim.err"), "w") as err_f:
            proc = subprocess.Popen(cmd, cwd=root, env=sim_env(root), stdout=out_f,
                                    stderr=err_f, text=True, start_new_session=True)
            try:
                if during is not None:
                    live = during(tmp, proc, deadline)
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
            else:
                timed_out = False
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        wall_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "sim.out")) as f, open(os.path.join(tmp, "sim.err")) as g:
            out, err = f.read(), g.read()
        logs = {}
        for name in sorted(os.listdir(tmp)):
            if name.startswith("node_0_") and name.endswith((".out", ".err")):
                with open(os.path.join(tmp, name)) as f:
                    logs[name] = f.read()
        if timed_out or proc.returncode != 0 or "run 0: success" not in out:
            why = f"no result within {limit_s} s" if timed_out else f"exit {proc.returncode}"
            tails = "\n".join(f"--- {k}\n{v[-3000:]}" for k, v in logs.items())
            raise AssertionError(f"{phase}: {why}\n{out[-2000:]}\n{err[-4000:]}\n{tails}")
        processes = kernel_lines(tmp, "node_0_", phase)
        if len(processes) != run.processes:
            raise AssertionError(f"{phase}: {len(processes)} node processes, "
                                 f"expected {run.processes}")
        with open(os.path.join(tmp, "results_0.csv"), newline="") as f:
            header, row = list(csv.reader(f))[:2]
        yield SimpleNamespace(cfg=cfg, run=run, tmp=tmp, out=out, err=err, logs=logs,
                              processes=processes, header=header,
                              col=dict(zip(header, map(float, row))), wall_s=wall_s,
                              live=live)


def sim_phase() -> dict:
    """Phase 9: the port's sim entry point on the repo's 128-node device
    config (module docstring), in a subprocess of its own process group, so
    that the time limit stops the node processes too. Raises on any failed
    check; returns the run's figures."""
    with sim_run("sim", SIM_CONFIG, SIM_CHANGES, SIM_RUN_CHANGES, SIM_LIMIT_S) as sim:
        pass
    cfg, run, header, col, wall_s = sim.cfg, sim.run, sim.header, sim.col, sim.wall_s
    processes = list(sim.processes.values())
    launches = col["device_verifier_verifierLaunches_sum"]
    per_process = [p["verifier_launches"] for p in processes]
    if launches < run.processes or not all(n and n >= 1 for n in per_process):
        raise AssertionError(f"sim: {launches} launches, by process {per_process}: "
                             "a shared verifier never launched")
    if not col["device_verifier_verifierCandidates_sum"] > 0:
        raise AssertionError("sim: the shared verifiers took no candidate")
    if not col["sigen_wall_avg"] > 0:
        raise AssertionError("sim: no sigen wall time in the results")
    launch_cols = [k for k in header if k.startswith("device_launch_")]
    if not launch_cols:
        raise AssertionError("sim: no device_launch_* column in the results")
    for k in ("device_verifier_failoverBatches_sum", "device_verifier_deviceRetryCt_sum"):
        if col[k] != 0:
            raise AssertionError(f"sim: {k} = {col[k]}")
    if not col["sigs_combineDeviceGroups_sum"] > 0:
        raise AssertionError("sim: no merge reached the device combine")
    b1 = sum(p["launches"]["fp_mont_mul"] for p in processes)
    if b1 == 0 or any(p["launches_in_round"]["fp_mont_mul"] == 0 for p in processes):
        raise AssertionError(f"sim: B1 did not launch in every node process: {processes}")
    dispatch_calls = col["device_dispatch_dispatchCalls_sum"]
    fig = {
        "config": SIM_CONFIG, "reduced": {**SIM_CHANGES, **SIM_RUN_CHANGES},
        "nodes": run.nodes,
        "threshold": run.resolved_threshold(), "processes": run.processes,
        "network": cfg.network, "shared_verifier": cfg.shared_verifier,
        "period_ms": run.handel.period_ms, "timeout_ms": run.handel.timeout_ms,
        "wall_s": wall_s, "launches": launches,
        "candidates": col["device_verifier_verifierCandidates_sum"],
        "occupancy_avg": col["device_verifier_verifierOccupancy_avg"],
        "launch_fill_avg": col["device_verifier_launchFillRatio_avg"],
        "dedup_hits": col["device_verifier_dedupHits_sum"],
        "sigen_wall_avg_s": col["sigen_wall_avg"], "sigen_wall_max_s": col["sigen_wall_max"],
        "launch_time_ms_avg": col["device_launch_launchTimeMs_avg"],
        "launch_time_ms_max": col["device_launch_launchTimeMs_max"],
        "dispatch_ms_per_call": col["device_dispatch_dispatchTimeMs_sum"] / max(1.0, dispatch_calls),
        "dispatch_max_ms": col["device_dispatch_dispatchMaxMs_max"],
        "sig_verify_failed": col["sigs_sigVerifyFailed_sum"],
        "combine_device_groups": col["sigs_combineDeviceGroups_sum"],
        "combine_host_groups": col["sigs_combineHostGroups_sum"],
        "subgroup_checks": col["device_subgroup_g2SubgroupChecks_sum"],
        "subgroup_check_ms": col["device_subgroup_g2SubgroupCheckTimeMs_sum"],
        "device_combine_s": [p["device_combine"]["combineTimeMs"] / 1000.0 for p in processes],
        "verifier_launches_by_process": per_process,
        "node_processes": processes, "b1_launches": b1,
        "b1_launches_in_round": sum(p["launches_in_round"]["fp_mont_mul"] for p in processes),
    }
    line("sim", **fig)
    return fig


def http(url: str, method: str = "GET", timeout: float = 10.0) -> tuple[int, bytes]:
    """(status, body) of one request to a node's metrics endpoint; status 0
    when it does not answer."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return 0, b""


def scrape_phase(tmp: str, proc, deadline: float) -> dict:
    """Phase 12's live checks, while its sim runs: each node process's
    endpoint (metrics_ports.json) answers /healthz and turns ready; one
    /metrics scrape of each carries the device_verifier plane and the
    card's memory gauges above 0; a /debug/profile capture of
    PROFILE_S seconds on the first process, once every process is ready,
    shows B1's kernel by name (PROFILE_TRIES captures at most). Returns the
    figures."""
    from handel_tpu_torch.core.metrics import parse_exposition

    def wait(what, cond):
        while not cond():
            if proc.poll() is not None:
                raise AssertionError(f"adversarial: the sim ended before {what}")
            if time.monotonic() > deadline:
                raise AssertionError(f"adversarial: no {what} within the limit")
            time.sleep(0.25)

    ports_file = os.path.join(tmp, "metrics_ports.json")
    wait("metrics_ports.json", lambda: os.path.exists(ports_file))
    time.sleep(0.5)  # written before the node processes spawn: let it close
    with open(ports_file) as f:
        addresses = json.load(f)["addresses"]
    t0 = time.monotonic()
    for addr in addresses.values():
        wait(f"/healthz at {addr}", lambda a=addr: http(f"http://{a}/healthz")[0] == 200)
    healthy_s = time.monotonic() - t0
    for addr in addresses.values():
        wait(f"/readyz 200 at {addr}", lambda a=addr: http(f"http://{a}/readyz")[0] == 200)
    ready_s = time.monotonic() - t0
    time.sleep(3.0)  # past the START barrier: the round is on the card
    scrapes = {}
    for pidx, addr in addresses.items():
        status, body = http(f"http://{addr}/metrics")
        if status != 200:
            raise AssertionError(f"adversarial: /metrics at {addr} answered {status}")
        fams = parse_exposition(body.decode())
        verifier = sorted(k for k in fams if k.startswith("handel_device_verifier_"))
        mem = {k: fams[k]["samples"][0][1] for k in (
            "handel_device_mem_bytes_in_use", "handel_device_mem_bytes_reserved",
            "handel_device_mem_bytes_peak") if k in fams}
        if not verifier:
            raise AssertionError(f"adversarial: no device_verifier plane at {addr}")
        if len(mem) != 3 or not all(v > 0 for v in mem.values()):
            raise AssertionError(f"adversarial: device memory gauges at {addr}: {mem}")
        scrapes[pidx] = {"families": len(fams), "device_verifier_families": len(verifier),
                         **{k[len("handel_device_"):]: v for k, v in mem.items()}}
    first = addresses[min(addresses, key=int)]
    profiles = []
    for _ in range(PROFILE_TRIES):
        status, body = http(f"http://{first}/debug/profile?seconds={PROFILE_S}", "POST",
                            timeout=60.0 + PROFILE_S)
        if status != 200:
            raise AssertionError(f"adversarial: /debug/profile answered {status}: {body[:300]}")
        with open(os.path.join(json.loads(body)["trace"], "kernels.json")) as f:
            kernels = json.load(f)
        b1 = [v for k, v in kernels.items() if "mont_mul_kernel" in k]
        profiles.append({"kernels": len(kernels), "activities": sum(c for c, _ in kernels.values()),
                         "device_ms": sum(ms for _, ms in kernels.values()),
                         "b1_calls": sum(c for c, _ in b1), "b1_ms": sum(ms for _, ms in b1)})
        if b1:
            break
    else:
        raise AssertionError(f"adversarial: {PROFILE_TRIES} profile captures without B1: {profiles}")
    return {"healthy_s": healthy_s, "ready_s": ready_s, "scrapes": scrapes,
            "profile_s": PROFILE_S, "profiles": profiles}


def thread_coverage(events: list, cp: dict) -> float:
    """The critical path's coverage of the time to threshold with the merge
    spans of the chain's own node threads counted beside the chain's spans.
    On the card a verified candidate waits for its node to merge the
    batch's earlier candidates, each with its device combine, before its
    own merge; the chain leaves that wait out of the trace CLI's
    `coverage`, and the node's own merge spans fill it."""
    from handel_tpu_torch.sim import trace_cli

    start, end = cp["start_ts"], cp["threshold_ts"]
    threads = {(e["pid"], e["tid"]) for e in cp["chain"]}
    ivs = [(start + e["t_ms"] * 1e3, min(start + (e["t_ms"] + e["dur_ms"]) * 1e3, end))
           for e in cp["chain"]]
    ivs += [(max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in events
            if e.get("ph") == "X" and e["name"] == "merge"
            and (e["pid"], e["tid"]) in threads and e["ts"] < end and e["ts"] + e["dur"] > start]
    return trace_cli._interval_union(ivs) / (end - start)


def trace_phase(trace_dir: str, processes: int, launches: float) -> dict:
    """Phase 12's trace checks: one trace per node process, each naming the
    service thread (SERVICE_TID) and its device lane, with its ring
    unwrapped; their launch spans (`device_verify`) as many as the CSV's
    verifier launches; the trace CLI exits 0 and its critical path, a
    chain through recv, verify and merge, covers at least
    90% of the time to threshold with its node threads' own merges counted
    (`thread_coverage`; the CLI's own coverage is reported beside it).
    Returns each launch's queue,
    pack-and-dispatch, on-device and fetch milliseconds from the spans, and
    the lanes' occupancy."""
    from handel_tpu_torch.core.trace import SERVICE_TID
    from handel_tpu_torch.sim import trace_cli

    files = sorted(os.listdir(trace_dir))
    traces = [f for f in files if f.startswith("trace_") and f.endswith(".json")]
    if len(traces) != processes:
        raise AssertionError(f"adversarial: {len(traces)} traces for {processes} processes")
    spans: dict[str, list[float]] = {}
    events_by_file = {}
    for name in traces:
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        threads = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
        if threads.get(SERVICE_TID) != "batch-verifier" or threads.get(-2) != "device-lane-0":
            raise AssertionError(f"adversarial: {name} names no service or lane thread: "
                                 f"{ {k: v for k, v in threads.items() if k < 0} }")
        recorded = sum(1 for e in events if e["ph"] != "M")
        if recorded >= ADV_CHANGES["trace_capacity"]:
            raise AssertionError(f"adversarial: {name}'s ring wrapped ({recorded} events)")
        events_by_file[name] = recorded
        for e in events:
            if e["ph"] == "X" and e["name"] in ("launch_queued", "dispatch_pack",
                                                "launch_on_device", "device_verify"):
                spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    launch_spans = len(spans.get("device_verify", []))
    if launch_spans != launches:
        raise AssertionError(f"adversarial: {launch_spans} launch spans, the CSV "
                             f"{launches} launches")
    report_path = os.path.join(trace_dir, "report.json")
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "handel_tpu_torch.sim", "trace", trace_dir,
                          "--critical-path", "--report", report_path],
                         capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"adversarial: trace CLI exit {cli.returncode}\n{cli.stderr[-3000:]}")
    with open(report_path) as f:
        report = json.load(f)
    cp = report["critical_path"]
    if cp is None or not {"recv", "verify", "merge"} <= {e["name"] for e in cp["chain"]}:
        raise AssertionError("adversarial: no critical path through recv, verify and merge")
    if min(cp["stages_ms"].values()) < 0:
        raise AssertionError(f"adversarial: a negative stage on the critical path: {cp}")
    events = trace_cli.load_traces([trace_dir])
    covered = thread_coverage(events, cp)
    if covered < 0.90:
        raise AssertionError(f"adversarial: critical path covers {covered} (CLI: "
                             f"{cp['coverage']}) of the time to threshold, under 0.90")
    occupancy = trace_cli.lane_occupancy(events)

    def summary(xs):
        xs = sorted(xs)
        return {"n": len(xs), "p50": statistics.median(xs) if xs else None,
                "max": xs[-1] if xs else None, "sum": sum(xs)}

    return {
        "events_by_file": events_by_file, "launch_spans": launch_spans,
        "per_launch_ms": {"queued": summary(spans.get("launch_queued", [])),
                          "pack_and_dispatch": summary(spans.get("dispatch_pack", [])),
                          "on_device": summary(spans.get("launch_on_device", [])),
                          "fetch": summary(spans.get("device_verify", []))},
        "lane_occupancy": occupancy, "trace_cli_s": cli_s,
        "time_to_threshold_s": report["time_to_threshold_s"],
        "critical_path": {**{k: cp[k] for k in ("wall_ms", "coverage", "hops", "stages_ms")},
                          "coverage_with_node_merges": covered,
                          "chain": [e["name"] for e in cp["chain"]]},
        "flow_linkage": report["flow_linkage"],
    }


def adversarial_phase() -> dict:
    """Phase 12: the port's sim on the repo's adversarial config (module
    docstring), traced and with its metrics endpoints on, in a subprocess of
    its own process group under ADV_LIMIT_S; scraped while it runs
    (`scrape_phase`), then its outputs, CSV and traces checked
    (`trace_phase`). Raises on any failed check; returns the figures."""
    with sim_run("adversarial", ADV_CONFIG, ADV_CHANGES, ADV_RUN_CHANGES, ADV_LIMIT_S,
                 during=scrape_phase) as sim:
        col = sim.col
        launches = col["device_verifier_verifierLaunches_sum"]
        traced = trace_phase(os.path.join(sim.tmp, "trace_0"), sim.run.processes, launches)
    cfg, run, live, wall_s = sim.cfg, sim.run, sim.live, sim.wall_s
    processes = list(sim.processes.values())
    banned = sorted({int(m) for text in sim.logs.values()
                     for m in re.findall(r"origin (\d+) is banned", text)})
    per_process = [p["verifier_launches"] for p in processes]
    if not all(n and n >= 1 for n in per_process):
        raise AssertionError(f"adversarial: verifier launches by process {per_process}")
    if any(p["launches_in_round"]["fp_mont_mul"] == 0 for p in processes):
        raise AssertionError(f"adversarial: B1 did not launch in every process in the round")
    if not col["sigs_sigVerifyFailed_sum"] > 0:
        raise AssertionError("adversarial: no forgery failed a device verdict")
    if not col["sigs_peerPenaltyReports_sum"] > 0:
        raise AssertionError("adversarial: no failure was attributed to a peer")
    from handel_tpu_torch.sim.adversary import adversary_roles

    roles = adversary_roles(run.adversaries.counts(), run.nodes)
    if any(b not in roles for b in banned):
        raise AssertionError(f"adversarial: banned origins {banned}, byzantine {roles}")
    for k in ("chaosDropped", "chaosCorrupted", "chaosDuplicated"):
        if not col[f"net_{k}_sum"] > 0:
            raise AssertionError(f"adversarial: net_{k}_sum = {col[f'net_{k}_sum']}")
    for k in ("failoverBatches", "deviceRetryCt", "breakerTransitionsCt"):
        if col[f"device_verifier_{k}_sum"] != 0:
            raise AssertionError(f"adversarial: device_verifier_{k}_sum = "
                                 f"{col[f'device_verifier_{k}_sum']}")
    # a launch's on-device span is its time on the verify stream: the lanes
    # are busy at least as much of their window as the profiled kernels
    busy_share = live["profiles"][-1]["device_ms"] / (PROFILE_S * 1e3)
    occupancy = traced["lane_occupancy"]["mean"]
    if occupancy < busy_share:
        raise AssertionError(f"adversarial: lane occupancy {occupancy} under the "
                             f"profile's busy share {busy_share}")
    dispatch_calls = col["device_dispatch_dispatchCalls_sum"]
    fig = {
        "config": ADV_CONFIG, "changed": ADV_CHANGES, "reduced": ADV_RUN_CHANGES,
        "nodes": run.nodes,
        "threshold": run.resolved_threshold(), "processes": run.processes,
        "network": cfg.network, "chaos": {k: getattr(cfg.chaos, k) for k in (
            "drop_rate", "corrupt_rate", "duplicate_rate", "seed")},
        "roles": {r: sum(1 for v in roles.values() if v == r) for r in set(roles.values())},
        "period_ms": run.handel.period_ms, "timeout_ms": run.handel.timeout_ms,
        "wall_s": wall_s, "launches": launches,
        "candidates": col["device_verifier_verifierCandidates_sum"],
        "launch_fill_avg": col["device_verifier_launchFillRatio_avg"],
        "dedup_hits": col["device_verifier_dedupHits_sum"],
        "sigen_wall_avg_s": col["sigen_wall_avg"], "sigen_wall_max_s": col["sigen_wall_max"],
        "launch_time_ms_avg": col["device_launch_launchTimeMs_avg"],
        "dispatch_ms_per_call": col["device_dispatch_dispatchTimeMs_sum"] / max(1.0, dispatch_calls),
        "host_pack_ms_per_launch": col["device_verifier_hostPackMsPerLaunch_avg"],
        "host_dispatch_ms_per_launch": col["device_verifier_hostDispatchMsPerLaunch_avg"],
        "sig_verify_failed": col["sigs_sigVerifyFailed_sum"],
        "penalty_reports": col["sigs_peerPenaltyReports_sum"],
        "peers_banned": col["sigs_peersBanned_sum"], "banned_origins": banned,
        "chaos_counts": {k: col[f"net_{k}_sum"] for k in (
            "chaosDropped", "chaosCorrupted", "chaosDuplicated")},
        "flooded": col["sigs_advFloodedCt_sum"], "replayed": col["sigs_advReplayedCt_sum"],
        "combine_device_groups": col["sigs_combineDeviceGroups_sum"],
        "device_combine_s": [p["device_combine"]["combineTimeMs"] / 1000.0 for p in processes],
        "verifier_launches_by_process": per_process,
        "node_processes": processes,
        "b1_launches": sum(p["launches"]["fp_mont_mul"] for p in processes),
        "b1_launches_in_round": sum(p["launches_in_round"]["fp_mont_mul"] for p in processes),
        "live": live, "trace": traced,
        "lane_occupancy_vs_busy": {"lane_occupancy": occupancy, "profile_busy_share": busy_share},
    }
    line("adversarial", **fig)
    return fig


def cut_link(client) -> None:
    """Cut a client's live link to a VerifierServer from outside, as a lost
    host or cable would: its socket shut down both ways, so each end reads
    end-of-file."""
    import socket

    client._writer.get_extra_info("socket").shutdown(socket.SHUT_RDWR)


def rpc_phase(cons, pks, sks, counters, prng) -> dict:
    """Phase 12's RPC case, one main-path run: a VerifierServer on loopback
    in front of one BatchVerifierService(fallback=None) over phase 4's cios
    engine; RPC_CLIENTS RPCVerifier clients, standing for hosts without a
    card, each ship RPC_CANDIDATES range candidates with phase 4's forged
    lanes at once: the verdicts as known by construction, fused into one
    launch. Then the link-loss path: the first client's next request in
    flight, the server stops and the link is cut; the request fails with a
    ConnectionError, and after the server restarts on its port the client's
    next call reconnects and gets its verdicts. Returns the figures."""
    import asyncio

    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.parallel.rpc_verifier import RPCVerifier, VerifierServer

    engine = cons._device
    batches = [make_requests("range", sks, RPC_CANDIDATES, prng, cons.Device)
               for _ in range(RPC_CLIENTS)]
    lost_reqs, lost_expect = make_requests("range", sks, 4, prng, cons.Device)
    every = [r for reqs, _ in batches for r in reqs]
    expect = [e for _, exp in batches for e in exp]
    # each client's empty-bitset lane (lane 3) is one content: the service
    # verifies it once, beside the distinct candidates
    distinct = len({(bs.marshal(), sig.marshal()) for bs, sig in every})
    svc = BatchVerifierService(engine, fallback=None, max_delay_ms=500.0)

    async def go():
        server = VerifierServer(svc, cons, host="127.0.0.1")
        await server.start()
        clients = [RPCVerifier(f"127.0.0.1:{server.port}", retry_delay=0.05)
                   for _ in range(RPC_CLIENTS)]
        try:
            t0 = time.perf_counter()
            got = await asyncio.gather(*(c.verify(MSG, None, reqs)
                                         for c, (reqs, _) in zip(clients, batches)))
            fused_s = time.perf_counter() - t0
            fused = svc.values()
            # the link-loss path
            lost = asyncio.ensure_future(clients[0].verify(MSG, None, lost_reqs))
            await asyncio.sleep(0.5)
            server.stop()
            cut_link(clients[0])
            try:
                await asyncio.wait_for(lost, 30.0)
                raise AssertionError("rpc: the request in flight survived the lost link")
            except ConnectionError as e:
                failed = repr(e)
            port = server.port
            server = VerifierServer(svc, cons, host="127.0.0.1", port=port)
            await server.start()
            again = await clients[0].verify(MSG, None, lost_reqs)
            return got, fused_s, fused, failed, again, [c.values() for c in clients], \
                server.values()
        finally:
            for c in clients:
                c.stop()
            server.stop()
            svc.stop()

    zero_counts(counters)
    got, fused_s, fused, failed, again, client_values, served = asyncio.run(go())
    launches = {k: c.launches for k, c in counters.items()}
    flat = [v for verdicts in got for v in verdicts]
    fig = {"clients": RPC_CLIENTS, "candidates": len(every), "distinct": distinct,
           "fused_s": fused_s, "fused_launches": fused["verifierLaunches"],
           "fused_candidates": fused["verifierCandidates"],
           "fused_dedup_hits": fused["dedupHits"],
           "launch_fill": fused["launchFillRatio"], "link_loss": failed,
           "after_reconnect": again == lost_expect, "client_values": client_values,
           "restarted_server_values": served, "kernel_launches": launches,
           "widths": width_histograms(counters)}
    line("rpc", **fig)
    if flat != expect:
        bad = [j for j, (g, e) in enumerate(zip(flat, expect)) if g != e]
        raise AssertionError(f"rpc: verdicts differ from the known ones at {bad}")
    if (fused["verifierLaunches"] != 1 or fused["verifierCandidates"] != distinct
            or fused["dedupHits"] != len(every) - distinct):
        raise AssertionError(f"rpc: {fused['verifierLaunches']} launches of "
                             f"{fused['verifierCandidates']} candidates, not one of {distinct}")
    if again != lost_expect:
        raise AssertionError(f"rpc: verdicts after reconnecting {again} != {lost_expect}")
    service_checks("rpc", fused)
    if launches["fp_mont_mul"] == 0:
        raise AssertionError("the rpc case never launched B1")
    for k in ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"):
        if launches[k] != 0:
            raise AssertionError(f"the rpc case launched {k} {launches[k]} times")
    return fig


def ban_case(cons, pks, sks, counters) -> dict:
    """Phase 12's ban case, one main-path run: node 0 of phase 4's registry,
    a Handel node that verifies through one BatchVerifierService(fallback=
    None) over phase 4's cios engine, receives BAN_FORGED content-distinct
    aggregates from the invalid signer at the top of its level BAN_LEVEL,
    as that role forwards them: its forged signature (sim/adversary.py
    forged_signature) alone, then beside one honest signature each. One
    launch on the card rejects every one, the node's scorer bans the signer
    (BAN_FORGED reports over its ban score), and the signer's next packet
    dies at validation. Raises on any failed check; returns the figures."""
    import asyncio

    import torch

    from handel_tpu_torch.core.bitset import BitSet
    from handel_tpu_torch.core.config import Config
    from handel_tpu_torch.core.crypto import MultiSignature
    from handel_tpu_torch.core.handel import Handel
    from handel_tpu_torch.core.identity import ArrayRegistry, Identity
    from handel_tpu_torch.core.net import Packet
    from handel_tpu_torch.core.test_harness import InProcessNetwork, InProcessRouter
    from handel_tpu_torch.models.bn254 import BN254SecretKey
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.sim.adversary import forged_signature

    engine = cons._device
    registry = ArrayRegistry([Identity(i, f"ban-{i}", pk) for i, pk in enumerate(pks)])
    svc = BatchVerifierService(engine, fallback=None)
    cfg = Config()
    cfg.verifier, cfg.batch_size = svc.verify, LANES
    router = InProcessRouter()
    own = BN254SecretKey(sks[0]).sign(MSG)

    async def go():
        h = Handel(InProcessNetwork(router, "ban-0"), registry, registry.identity(0),
                   cons, MSG, own, cfg)
        lvl = h.levels[BAN_LEVEL]
        signer = max(ident.id for ident in lvl.nodes)
        forged = forged_signature(BN254SecretKey(sks[signer]), MSG)
        honest = [ident.id for ident in lvl.nodes if ident.id != signer][:BAN_FORGED - 1]
        aggregates = [({signer}, forged)] + [
            ({signer, j}, forged.combine(BN254SecretKey(sks[j]).sign(MSG))) for j in honest]
        net = InProcessNetwork(router, f"ban-{signer}")

        def packet(members, sig):
            bs = BitSet(len(lvl.nodes))
            for i in members:
                bs.set(h.partitioner.index_at_level(i, BAN_LEVEL), True)
            return Packet(origin=signer, level=BAN_LEVEL,
                          multisig=MultiSignature(bs, sig).marshal())

        h.proc.start()
        try:
            t0 = time.perf_counter()
            for members, sig in aggregates:
                net.send([registry.identity(0)], packet(members, sig))
            while h.proc.sig_verify_failed < len(aggregates):
                if time.perf_counter() - t0 > BAN_LIMIT_S:
                    raise AssertionError(f"ban: {h.proc.sig_verify_failed} of "
                                         f"{len(aggregates)} verdicts in {BAN_LIMIT_S} s")
                await asyncio.sleep(0.05)
            wall_s = time.perf_counter() - t0
            banned = [i for i in range(len(pks)) if h.scorer.banned(i)]
            before = h.banned_packet_ct
            net.send([registry.identity(0)], packet(*aggregates[0]))
            await asyncio.sleep(0.05)
            return {"signer": signer, "level": BAN_LEVEL, "forged": len(aggregates),
                    "wall_s": wall_s, "sig_verify_failed": h.proc.sig_verify_failed,
                    "sig_checked": h.proc.sig_checked_ct, "banned": banned,
                    "score": h.scorer.score(signer), "ban_score": h.scorer.ban_threshold,
                    "dropped_after_ban": h.banned_packet_ct - before}
        finally:
            h.proc.stop()
            svc.stop()

    zero_counts(counters)
    fig = asyncio.run(go())
    torch.cuda.synchronize(engine.device)
    launches = {k: c.launches for k, c in counters.items()}
    served = svc.values()
    fig.update(service_launches=served["verifierLaunches"],
               service_candidates=served["verifierCandidates"],
               kernel_launches=launches, widths=width_histograms(counters))
    line("ban", **fig)
    if (fig["sig_verify_failed"], fig["sig_checked"]) != (fig["forged"], fig["forged"]):
        raise AssertionError(f"ban: {fig['sig_verify_failed']} failed of "
                             f"{fig['sig_checked']} checked, {fig['forged']} forged")
    if served["verifierLaunches"] != 1 or served["verifierCandidates"] != fig["forged"]:
        raise AssertionError(f"ban: {served['verifierLaunches']} launches of "
                             f"{served['verifierCandidates']} candidates")
    if fig["banned"] != [fig["signer"]] or fig["dropped_after_ban"] != 1:
        raise AssertionError(f"ban: banned {fig['banned']}, {fig['dropped_after_ban']} "
                             f"packets dropped after the ban")
    service_checks("ban", served)
    if launches["fp_mont_mul"] == 0:
        raise AssertionError("the ban case never launched B1")
    for k in ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"):
        if launches[k] != 0:
            raise AssertionError(f"the ban case launched {k} {launches[k]} times")
    return fig


def lifecycle_phase(cons, pks, sks, counters) -> dict:
    """Phase 14, one main-path run: a live validator-set rotation on phase
    4's cios engine under four sessions' load (module docstring). Raises on
    any failed check; returns the figures."""
    import asyncio

    import torch

    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.lifecycle import EpochManager, LifecycleController
    from handel_tpu_torch.service.driver import MultiSessionCluster
    from handel_tpu_torch.sim.config import AlertParams

    engine = cons._device
    dev = engine.device
    t0 = time.perf_counter()
    rng = random.Random(LIFECYCLE_SEED)
    sks_b, pks_b = make_registry(N_REGISTRY, rng, cons.Device)
    keygen_s = time.perf_counter() - t0
    half = N_REGISTRY // 2
    sks_c, pks_c = sks[:half], pks[:half]

    def batches(keys):
        return [make_requests("range", keys, LIFECYCLE_CANDIDATES, rng, cons.Device)
                for _ in range(LIFECYCLE_SESSIONS)]

    loads = {"epoch0": batches(sks), "staging": batches(sks), "epoch1": batches(sks_b),
             "epoch2": batches(sks_c)}
    # the epoch-0 candidate sent again under B: session s0's honest lane 0
    again = loads["epoch0"][0][0][0]
    loads["epoch1"][0][0][0] = again
    loads["epoch1"][0][1][0] = False

    # the rotation's two engine calls, each counted on its own thread
    stagings, flips = [], []
    stage_registry, activate_staged = engine.stage_registry, engine.activate_staged

    def stage(pubkeys, build_prefix=True):
        a0 = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        with mont_mul.tally() as widths:
            n = stage_registry(pubkeys, build_prefix)
        stagings.append({
            "keys": n, "ms": (time.perf_counter() - t) * 1e3, "span": (t, time.perf_counter()),
            "b1_calls": sum(widths.values()),
            "b1_widths": {str(c): k for c, k in sorted(widths.items())},
            "bank_bytes": sum(x.nbytes for x in engine._staged.tensors()),
            "allocated_delta": torch.cuda.memory_allocated(dev) - a0,
        })
        return n

    def flip():
        t = time.perf_counter()
        with mont_mul.tally() as widths:
            epoch = activate_staged()
        flips.append({"epoch": epoch, "ms": (time.perf_counter() - t) * 1e3,
                      "b1_calls": sum(widths.values())})
        return epoch

    engine.stage_registry, engine.activate_staged = stage, flip
    calls = LaneCalls(engine)
    # the serve driver's wiring over the engine: one service with no
    # fallback, its session manager, and the [alerts] plane with the
    # breaker-storm and queue-depth detectors; its sessions are the four
    # tenants below, not Handel committees, so `run` is never called
    cluster = MultiSessionCluster(LIFECYCLE_SESSIONS, 0, device=engine, alert_p=AlertParams())
    svc, manager, alerts = cluster.service, cluster.manager, cluster.alerts
    epochs = EpochManager(svc, manager)
    controller = LifecycleController(svc, epoch_manager=epochs, alert_plane=alerts,
                                     interval_s=LIFECYCLE_TICK_S)
    engine.reset_host_counters()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    allocated0 = torch.cuda.memory_allocated(dev)
    marks: dict[str, dict] = {}

    def mark(name):
        v = svc.values()
        marks[name] = {"t": time.perf_counter(), "launches": v["verifierLaunches"],
                       "dedup_hits": sum(svc.tenant_dedup_hits.values())}

    keys = {"epoch0": pks, "staging": pks, "epoch1": pks_b, "epoch2": pks_c}

    def send(name):
        return asyncio.gather(*(
            svc.verify(MSG, keys[name], reqs, session=f"s{i}")
            for i, (reqs, _) in enumerate(loads[name])
        ))

    async def go():
        calls.loop = asyncio.get_running_loop()
        controller.start()
        try:
            got = {}
            mark("start")
            got["epoch0"] = await send("epoch0")
            mark("epoch0")
            in_flight = asyncio.ensure_future(send("staging"))
            # stage once the batch's launch is under way (collected, in its
            # dispatch, or in flight)
            while svc._plane_idle() and not in_flight.done():
                await asyncio.sleep(0.001)
            await epochs.begin_rotation(pks_b)
            got["staging"] = await in_flight
            await epochs.commit_rotation()
            mark("staging")
            got["epoch1"] = await send("epoch1")
            mark("epoch1")
            await epochs.rotate(pks_c)
            got["epoch2"] = await send("epoch2")
            mark("epoch2")
            return got
        finally:
            await controller.stop()
            cluster.stop()

    zero_counts(counters)
    t0 = time.perf_counter()
    try:
        got = asyncio.run(go())
    finally:
        calls.restore()
        del engine.stage_registry, engine.activate_staged
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    launches = {k: c.launches for k, c in counters.items()}
    values, ev = svc.values(), epochs.values()
    names = ["epoch0", "staging", "epoch1", "epoch2"]
    per_epoch = {n: marks[n]["launches"] - marks[p]["launches"]
                 for p, n in zip(["start"] + names, names)}
    # a launch runs from its dispatch's start to its fetch's end
    spans = [(d[0], f[1]) for d, f in zip(sorted(calls.spans["dispatch"]),
                                          sorted(calls.spans["fetch"]))]
    overlapped = [sum(1 for a, b in spans if a < st["span"][1] and b > st["span"][0])
                  for st in stagings]
    fig = {
        "registry": N_REGISTRY, "sessions": LIFECYCLE_SESSIONS,
        "candidates_per_session": LIFECYCLE_CANDIDATES, "lanes": LANES,
        "keygen_s": keygen_s, "wall_s": wall_s,
        "staging": [{k: v for k, v in st.items() if k != "span"} for st in stagings],
        "flips": flips, "swap_stall_ms": epochs.stall_ms,
        "max_epoch_swap_stall_ms": ev["maxEpochSwapStallMs"],
        "launches_per_epoch": per_epoch, "launches_overlapping_staging": overlapped,
        "dedup_hits_in_epoch1": marks["epoch1"]["dedup_hits"] - marks["staging"]["dedup_hits"],
        "epoch": {"service": svc.epoch, "engine": engine.epoch, "manager": manager.epoch},
        "controller_ticks": controller.ticks,
        "incidents_opened": alerts.incidents.opened,
        "incident_rules": [sorted(i.rules) for i in alerts.incidents.incidents],
        "max_memory_allocated_delta": torch.cuda.max_memory_allocated(dev) - allocated0,
        "kernel_launches": launches, "widths": width_histograms(counters),
        "host_pack_ms_per_launch": values["hostPackMsPerLaunch"],
        "host_dispatch_ms_per_launch": values["hostDispatchMsPerLaunch"],
    }
    line("lifecycle", **fig)
    for name in names:
        for i, (verdicts, (_reqs, expect)) in enumerate(zip(got[name], loads[name])):
            if verdicts != expect:
                bad = [j for j, (g, e) in enumerate(zip(verdicts, expect)) if g != e]
                raise AssertionError(f"lifecycle {name}: session s{i} verdicts wrong at {bad}")
    if fig["epoch"] != {"service": 2, "engine": 2, "manager": 2}:
        raise AssertionError(f"lifecycle: epochs {fig['epoch']}, not 2")
    if engine.n != half or engine.bank.n != half:
        raise AssertionError(f"lifecycle: the engine serves {engine.n} keys, not {half}")
    if len(stagings) != 2 or not all(st["b1_calls"] > 0 for st in stagings):
        raise AssertionError(f"lifecycle: B1 not launched inside each staging: {stagings}")
    if len(flips) != 2 or any(f["b1_calls"] for f in flips):
        raise AssertionError(f"lifecycle: B1 launched inside activate_staged: {flips}")
    if overlapped[0] < 1:
        raise AssertionError("lifecycle: no launch was in flight during the first staging")
    if fig["dedup_hits_in_epoch1"] != 0:
        raise AssertionError("lifecycle: the epoch-0 candidate was a dedup hit in epoch 1")
    if any(n < 1 for n in per_epoch.values()):
        raise AssertionError(f"lifecycle: an epoch ran no launch: {per_epoch}")
    service_checks("lifecycle", values)
    for key in ("admissionRefused", "admissionShed"):
        if values[key] != 0:
            raise AssertionError(f"lifecycle: {key} = {values[key]}")
    if fig["incidents_opened"] or controller.ticks < 1:
        raise AssertionError(f"lifecycle: {fig['incidents_opened']} incidents, "
                             f"{controller.ticks} controller ticks")
    if launches["fp_mont_mul"] == 0:
        raise AssertionError("lifecycle: B1 never launched")
    for k in ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"):
        if launches[k] != 0:
            raise AssertionError(f"lifecycle: {k} launched {launches[k]} times")
    return fig


def weighted_phase() -> dict:
    """Phase 15: the port's sim on the repo's weighted, churning geo config
    (module docstring), in a subprocess of its own process group under
    GEO_LIMIT_S. Raises on any failed check; returns the run's figures."""
    from handel_tpu_torch.scenario.weights import make_weights
    from handel_tpu_torch.sim.adversary import ROLE_CHURNER, adversary_roles
    from handel_tpu_torch.sim.allocator import new_allocator

    with sim_run("weighted", GEO_CONFIG, GEO_CHANGES,
                 {**GEO_RUN_CHANGES, "adversaries.churner": GEO_CHURNERS}, GEO_LIMIT_S) as sim:
        pass
    cfg, run, col, wall_s, processes = sim.cfg, sim.run, sim.col, sim.wall_s, sim.processes
    # the checks on the node processes' own outputs: no stall, no traceback
    # (C3: a delayed send that fires after its network stopped is dropped)
    for name, text in {"sim.err": sim.err, **sim.logs}.items():
        for bad in ("STALLED", "Traceback"):
            if bad in text:
                raise AssertionError(f"weighted: {bad} in {name}:\n{text[-4000:]}")
    # the gate, derived here as the node derives it from the TOML
    weights = make_weights(cfg.scenario.weight_profile, run.nodes,
                           seed=cfg.scenario.weight_seed)
    threshold = run.resolved_threshold()
    gate = cfg.scenario.weight_threshold(threshold, run.nodes, weights)
    alloc = new_allocator(cfg.allocator).allocate(run.nodes, 1, run.processes, run.failing)
    offline = {nid for nid, slot in alloc.items() if not slot.active}
    roles = adversary_roles(run.adversaries.counts(), run.nodes, offline)
    churners = sorted(i for i, r in roles.items() if r == ROLE_CHURNER)
    if len(churners) != GEO_CHURNERS:
        raise AssertionError(f"weighted: churners {churners}")
    stakes, departures, per_process, b1_by_process = {}, {}, [], {}
    for name, kern in sorted(processes.items()):
        p = kern["weighted"]
        pid = int(name[len("node_0_"):-len(".out")])
        local = sum(1 for c in churners if alloc[c].process == pid)
        if p["gate"] != gate:
            raise AssertionError(f"weighted: {name} gate {p['gate']}, expected {gate}")
        short = {k: v for k, v in p["departures"].items() if v < local}
        if short:
            raise AssertionError(f"weighted: {name} nodes {short} missed some of their "
                                 f"process's {local} churners")
        below = {k: v for k, v in p["final_stakes"].items() if v < gate - 1e-9}
        if below or len(p["final_stakes"]) != len(p["departures"]):
            raise AssertionError(f"weighted: {name} finals {p['final_stakes']} "
                                 f"against the gate {gate}")
        stakes.update(p["final_stakes"])
        departures.update(p["departures"])
        if not (kern["verifier_launches"] and kern["verifier_launches"] >= 1):
            raise AssertionError(f"weighted: {name} verifier launches "
                                 f"{kern['verifier_launches']}")
        if kern["launches_in_round"]["fp_mont_mul"] == 0:
            raise AssertionError(f"weighted: B1 did not launch in {name}'s round")
        per_process.append(kern["verifier_launches"])
        b1_by_process[pid] = kern["launches_in_round"]["fp_mont_mul"]
    if len(stakes) != run.nodes - len(churners):
        raise AssertionError(f"weighted: {len(stakes)} finals, expected "
                             f"{run.nodes - len(churners)}")
    if col["sigs_thresholdUnreachableCt_max"] != 0:
        raise AssertionError("weighted: a node found the threshold unreachable")
    if not (col["net_geoDelayed_sum"] > 0 and col["net_delayMs_n"] > 0):
        raise AssertionError("weighted: no geo delay in the results")
    if not col["device_verifier_verifierCandidates_sum"] > 0:
        raise AssertionError("weighted: the shared verifiers took no candidate")
    for k in ("failoverBatches", "deviceRetryCt", "breakerTransitionsCt"):
        if col[f"device_verifier_{k}_sum"] != 0:
            raise AssertionError(f"weighted: device_verifier_{k}_sum = "
                                 f"{col[f'device_verifier_{k}_sum']}")
    dispatch_calls = col["device_dispatch_dispatchCalls_sum"]
    fig = {
        "config": GEO_CONFIG, "changed": GEO_CHANGES,
        "reduced": {**GEO_RUN_CHANGES, "churner": GEO_CHURNERS},
        "nodes": run.nodes, "threshold": threshold, "processes": run.processes,
        "planet": cfg.scenario.planet, "weight_profile": cfg.scenario.weight_profile,
        "churners": churners, "churn_after_ms": run.adversaries.churn_after_ms,
        "wall_s": wall_s, "sigen_wall_avg_s": col["sigen_wall_avg"],
        "sigen_wall_max_s": col["sigen_wall_max"],
        "launches": col["device_verifier_verifierLaunches_sum"],
        "candidates": col["device_verifier_verifierCandidates_sum"],
        "launch_fill_avg": col["device_verifier_launchFillRatio_avg"],
        "dedup_hits": col["device_verifier_dedupHits_sum"],
        "dispatch_ms_per_call": col["device_dispatch_dispatchTimeMs_sum"] / max(1.0, dispatch_calls),
        "departures": departures,
        "departed_ct": {k: col[f"sigs_departedCt_{k}"] for k in ("min", "max", "sum")},
        "sig_departed_dropped": col["sigs_sigDepartedDropped_sum"],
        "weight_gate": gate, "stake_total": float(sum(weights)),
        "achieved_stake": {"min": min(stakes.values()), "max": max(stakes.values())},
        "geo_delayed": col["net_geoDelayed_sum"],
        "delay_ms": {k: col[f"net_delayMs_{k}"] for k in ("p50", "p90", "p99")},
        "combine_device_groups": col["sigs_combineDeviceGroups_sum"],
        "device_combine_s": [p["device_combine"]["combineTimeMs"] / 1000.0
                             for p in processes.values()],
        "verifier_launches_by_process": per_process,
        "b1_launches_in_round_by_process": b1_by_process,
        "b1_launches": sum(p["launches"]["fp_mont_mul"] for p in processes.values()),
        "b1_launches_in_round": sum(b1_by_process.values()),
        "max_memory_allocated": [p["max_memory_allocated"] for p in processes.values()],
    }
    line("weighted", **fig)
    return fig


def kill_nodes_under(path: str) -> None:
    """SIGKILL every node process whose command line names `path`: the
    remote platform starts each host's node processes in sessions of their
    own (their `--tag` is the host's staging dir), out of reach of the
    orchestrator's process group."""
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "handel_tpu_torch.sim.node" in cmd and path in cmd:
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass


def fleet_phase() -> dict:
    """Phase 13 (module docstring): the remote platform's fleet and `sim
    watch` on the repo's watched config, as two subprocesses at once, each
    in a process group of its own under REMOTE_LIMIT_S. Raises on any
    failed check; returns the figures."""
    from handel_tpu_torch.core.metrics import parse_exposition
    from handel_tpu_torch.sim.config import HostSpec, dump_config, load_config

    root = Path(__file__).resolve().parent
    cfg = load_config(str(root / REMOTE_CONFIG))
    for key, value in REMOTE_CHANGES.items():
        setattr(cfg, key, value)
    run = cfg.runs[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        watch_toml, remote_toml = (os.path.join(tmp, f"{n}.toml") for n in ("watch", "remote"))
        with open(watch_toml, "w") as f:
            f.write(dump_config(cfg))
        cfg.hosts = [HostSpec(connect="local", workdir=os.path.join(tmp, "hostA"), device=True),
                     HostSpec(connect="local", workdir=os.path.join(tmp, "hostB"))]
        with open(remote_toml, "w") as f:
            f.write(dump_config(cfg))
        remote_dir, watch_dir = os.path.join(tmp, "remote"), os.path.join(tmp, "watch")
        snapshot_path = os.path.join(tmp, "snapshot.txt")
        env = dict(os.environ, HANDEL_TORCH_DEVICE="cuda",
                   PYTHONPATH=os.pathsep.join(
                       [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))
        cmds = {
            "remote": [sys.executable, "-m", "handel_tpu_torch.sim", "--config", remote_toml,
                       "--workdir", remote_dir, "--platform", "remote"],
            "watch": [sys.executable, "-m", "handel_tpu_torch.sim", "watch", watch_toml,
                      "--workdir", watch_dir, "--interval", "1.0", "--snapshot", snapshot_path,
                      "--max-seconds", str(WATCH_MAX_S)],
        }
        t0 = time.perf_counter()
        deadline = time.monotonic() + REMOTE_LIMIT_S
        procs, walls, outs = {}, {}, {}
        try:
            for name, cmd in cmds.items():
                procs[name] = subprocess.Popen(
                    cmd, cwd=root, env=env, stdout=open(os.path.join(tmp, f"{name}.out"), "w"),
                    stderr=open(os.path.join(tmp, f"{name}.err"), "w"), text=True,
                    start_new_session=True)
            while len(walls) < len(procs):
                for name, proc in procs.items():
                    if name not in walls and proc.poll() is not None:
                        walls[name] = time.perf_counter() - t0
                if time.monotonic() > deadline:
                    raise AssertionError(f"fleet: no result within {REMOTE_LIMIT_S} s "
                                         f"(done: {sorted(walls)})")
                time.sleep(0.5)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            kill_nodes_under(tmp)
        for name in cmds:
            with open(os.path.join(tmp, f"{name}.out")) as f, \
                    open(os.path.join(tmp, f"{name}.err")) as g:
                outs[name] = (f.read(), g.read())
        for name, proc in procs.items():
            out, err = outs[name]
            if proc.returncode != 0 or "run 0: success" not in out:
                run_dir = remote_dir if name == "remote" else watch_dir
                tails = "\n".join(
                    f"--- {n}\n{open(os.path.join(run_dir, n)).read()[-2500:]}"
                    for n in sorted(os.listdir(run_dir)) if n.startswith("node_0_"))
                raise AssertionError(f"fleet: {name} exit {proc.returncode}\n{out[-1500:]}\n"
                                     f"{err[-3000:]}\n{tails}")

        # (a) the remote platform: one card process, the rest chip-less
        remote = kernel_lines(remote_dir, "node_0_", "fleet")
        with open(os.path.join(remote_dir, "results_0.csv"), newline="") as f:
            header, row = list(csv.reader(f))[:2]
        col = dict(zip(header, map(float, row)))
        if len(remote) != 2 * run.processes:
            raise AssertionError(f"fleet: {len(remote)} node processes, expected "
                                 f"{2 * run.processes}: {sorted(remote)}")
        servers = {k: v for k, v in remote.items() if v["verifier_launches"] is not None}
        chipless = {k: v for k, v in remote.items() if k not in servers}
        if len(servers) != 1 or not next(iter(servers)).startswith("node_0_0_"):
            raise AssertionError(f"fleet: serving processes {sorted(servers)}, expected one "
                                 "of host A")
        (server,) = servers.values()
        if not (server["initialized_cuda"] and server["verifier_launches"] >= 1
                and server["launches_in_round"]["fp_mont_mul"] > 0):
            raise AssertionError(f"fleet: host A's server did not launch B1: {server}")
        for name, k in chipless.items():
            if k["initialized_cuda"] or any(k["launches"].values()):
                raise AssertionError(f"fleet: chip-less {name} touched the card: {k}")
        for k in ("device_rpc_rpcSentCandidates_sum", "device_rpcserve_rpcServedCandidates_sum",
                  "device_verifier_verifierLaunches_sum"):
            if not col.get(k, 0.0) > 0:
                raise AssertionError(f"fleet: {k} = {col.get(k)}")
        for k in ("device_rpc_rpcLinkErrors_sum", "device_verifier_failoverBatches_sum",
                  "device_verifier_deviceRetryCt_sum", "device_verifier_breakerTransitionsCt_sum"):
            if col[k] != 0:
                raise AssertionError(f"fleet: {k} = {col[k]}")

        # (b) watch: both endpoints snapshotted, every process on the card
        with open(snapshot_path) as f:
            snap = f.read()
        texts = [t for t in re.split(r"^# scrape http://\S+/metrics\n", snap, flags=re.M)
                 if t.strip()]
        with open(os.path.join(watch_dir, "metrics_ports.json")) as f:
            endpoints = json.load(f)["addresses"]
        if len(texts) != len(endpoints) or len(endpoints) != run.processes:
            raise AssertionError(f"fleet: snapshot of {len(texts)} endpoints, the run "
                                 f"served {sorted(endpoints.values())}")
        families = [parse_exposition(t) for t in texts]
        watched = kernel_lines(watch_dir, "node_0_", "fleet")
        if len(watched) != run.processes or not all(
                k["initialized_cuda"] and k["launches_in_round"]["fp_mont_mul"] > 0
                for k in watched.values()):
            raise AssertionError(f"fleet: watch's node processes: {watched}")
        if "aggregation wave" not in outs["watch"][0]:
            raise AssertionError("fleet: watch rendered no dashboard")
    fig = {
        "config": REMOTE_CONFIG, "changed": REMOTE_CHANGES, "nodes": run.nodes,
        "threshold": run.resolved_threshold(), "processes_a_host": run.processes,
        "wall_s": walls,
        "remote": {
            "hosts": {"A": "device", "B": "chip-less"},
            "launches": col["device_verifier_verifierLaunches_sum"],
            "candidates": col["device_verifier_verifierCandidates_sum"],
            "rpc_sent_candidates": col["device_rpc_rpcSentCandidates_sum"],
            "rpc_sent_requests": col["device_rpc_rpcSentRequests_sum"],
            "rpc_served_candidates": col["device_rpcserve_rpcServedCandidates_sum"],
            "sigen_wall_max_s": col["sigen_wall_max"],
            "b1_launches": server["launches"]["fp_mont_mul"],
            "b1_launches_in_round": server["launches_in_round"]["fp_mont_mul"],
            "b1_widths": server["fp_mont_mul_widths"],
            "chipless_b1_launches": sum(k["launches"]["fp_mont_mul"] for k in chipless.values()),
            "chipless_cuda_initialized": [k["initialized_cuda"] for k in chipless.values()],
            "node_processes": remote,
        },
        "watch": {
            "endpoints": len(texts),
            "families": len(set().union(*families)),
            "families_by_endpoint": [len(f) for f in families],
            "b1_launches_in_round": [k["launches_in_round"]["fp_mont_mul"]
                                     for k in watched.values()],
            "verifier_launches": [k["verifier_launches"] for k in watched.values()],
        },
    }
    line("fleet", **fig)
    return fig


def snapshot(counters) -> dict:
    """Each kernel's launch count and B1's and B2's histograms by column
    and by row count, for `moved`."""
    return {k: (c.launches, dict(getattr(c, "widths", {})), dict(getattr(c, "rows", {})))
            for k, c in counters.items()}


def moved(counters, before) -> dict:
    """{kernel: launches, calls by column count and by row count} since the
    `snapshot` `before`, for the kernels that launched."""
    def diff(now, then):
        return {str(x): n - then.get(x, 0) for x, n in sorted(now.items()) if n != then.get(x, 0)}

    out = {}
    for k, c in counters.items():
        n0, w0, r0 = before[k]
        if c.launches != n0:
            out[k] = {"launches": c.launches - n0,
                      "widths": diff(getattr(c, "widths", {}), w0),
                      "rows": diff(getattr(c, "rows", {}), r0)}
    return out


class RlcCase:
    """One case of phase 10 on one engine, as a context around its launch:
    the wall from dispatch to verdicts, the engine's RLC counters and host
    costs over the case (both zeroed at its start), the kernels' launches
    and B1's and B2's calls by column count in it."""

    def __init__(self, name, engine, counters, expect_launch):
        self.name, self.engine, self.counters = name, engine, counters
        self.expect_launch = expect_launch
        self.fig: dict = {}

    def __enter__(self):
        self.engine.reset_host_counters()
        self.multi0 = self.engine.multi_msg_launches
        self.before = snapshot(self.counters)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        eng = self.engine
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        delta = moved(self.counters, self.before)
        launches = {k: delta[k]["launches"] if k in delta else 0 for k in self.counters}
        widths = {k: d["widths"] for k, d in delta.items() if d["widths"]}
        st = eng.rlc_stats
        per = lambda ms, n: ms / n if n else 0.0  # noqa: E731
        self.fig = {
            "case": self.name, "wall_ms": wall_ms,
            "rlc_stats": {"rlc_launches": st.rlc_launches, "bisection_ct": st.bisection_ct,
                          "bisection_depth_max": st.bisection_depth_max,
                          "miller_lanes": st.miller_lanes, "final_exp_lanes": st.final_exp_lanes},
            "engine_launches": eng.host_dispatch_launches,
            "multi_msg_launches": eng.multi_msg_launches - self.multi0,
            "host_pack_ms_per_launch": per(eng.host_pack_ms, eng.host_pack_launches),
            "host_dispatch_ms_per_launch": per(eng.host_dispatch_ms, eng.host_dispatch_launches),
            "kernel_launches": launches, "widths": widths,
        }
        return False

    def check(self, got, expect, **want):
        """Prints the case's line; then `expect_launch` must have launched
        and no other kernel, and the verdicts and the figures named in
        `want` (RlcStats fields or figure keys) must be as expected."""
        fig = {**self.fig, **self.fig["rlc_stats"]}
        line("rlc", **self.fig)
        for k, n in fig["kernel_launches"].items():
            if (k == self.expect_launch) != (n > 0):
                raise AssertionError(f"rlc {self.name}: {k} launched {n} times")
        if got != expect:
            bad = [j for j, (g, e) in enumerate(zip(got, expect)) if g != e]
            raise AssertionError(f"rlc {self.name}: verdicts wrong at lanes {bad}")
        for key, value in want.items():
            if fig[key] != value:
                raise AssertionError(f"rlc {self.name}: {key} = {fig[key]}, expected {value}")


def rlc_phase(cons, rcons, sks, pks, counters, prng, p50_ms) -> dict:
    """Phase 10: the RLC batch check and mixed-message launches at 4096 keys
    and 128 lanes (module docstring), on RLC engines that share phase 4's
    registry banks and prefix tables. One main-path run: every count set to
    0 before case (b) and read after case (f). Raises on any failed check;
    returns the figures."""
    import asyncio

    import torch

    from handel_tpu_torch.models.bn254_torch import BN254Device
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService

    base, rbase = cons._device, rcons._device
    dev = base.device
    eng = BN254Device(bank=base.bank, batch_size=LANES, curves=cons.curves,
                      batch_check="rlc", rlc_rng=random.Random(SEED))
    range_reqs, range_expect = make_requests("range", sks, LANES, prng, BN254Device, honest=True)
    dense_reqs, dense_expect = make_requests("dense", sks, DENSE_CANDIDATES, prng, BN254Device,
                                             honest=True)
    for kind, reqs in (("range", range_reqs), ("dense", dense_reqs)):
        if eng._pack_requests(reqs).kind != kind:
            raise AssertionError(f"rlc: {kind} requests packed as another launch class")
    # (a), the honest range launch on cios, was cut to pay for phase 16: its
    # requests still feed (f)
    per_session = LANES // RLC_SESSIONS
    session_msgs = [MSG + b" session %d" % i for i in range(RLC_SESSIONS)]
    sessions = [make_requests("range", sks, per_session, prng, BN254Device, msg=m, honest=True)
                for m in session_msgs]
    pair = [make_requests("range", sks, 1, prng, BN254Device, honest=True)[0][0],
            make_requests("range", sks, 3, prng, BN254Device)[0][2]]  # over another message
    mixed = [make_requests("range", sks, per_session, prng, BN254Device, msg=m)
             for m in session_msgs]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    t_phase = time.perf_counter()
    cases = {}

    # (b): one honest dense launch, one message
    with RlcCase("dense", eng, counters, "fp_mont_mul") as case:
        got = eng.fetch(eng.dispatch(MSG, dense_reqs))
    case.fig["candidates"] = len(dense_reqs)
    case.check(got, dense_expect, rlc_launches=1, bisection_ct=0, miller_lanes=2,
               final_exp_lanes=1, engine_launches=1)
    cases["dense"] = case.fig

    # (c) four sessions, four messages, one service launch
    calls = LaneCalls(eng)
    svc = BatchVerifierService(eng, fallback=None)

    async def serve():
        calls.loop = asyncio.get_running_loop()
        try:
            return await asyncio.gather(*(
                svc.verify(m, pks, reqs, session=f"s{i}")
                for i, (m, (reqs, _)) in enumerate(zip(session_msgs, sessions))))
        finally:
            svc.stop()

    try:
        with RlcCase("service", eng, counters, "fp_mont_mul") as case:
            got = asyncio.run(serve())
    finally:
        calls.restore()
    values = svc.values()
    case.fig.update(launches=values["verifierLaunches"], launch_fill=values["launchFillRatio"],
                    rlcLaunches=values["rlcLaunches"],
                    dispatch_s=[b - a for a, b in calls.spans["dispatch"]],
                    fetch_s=[b - a for a, b in calls.spans["fetch"]])
    case.check([v for vs in got for v in vs], [e for _, exp in sessions for e in exp],
               rlc_launches=1, bisection_ct=0, miller_lanes=RLC_SESSIONS + 1, final_exp_lanes=1,
               multi_msg_launches=1, launches=1.0, launch_fill=1.0, rlcLaunches=1.0)
    service_checks("rlc service", values)
    cases["service"] = case.fig

    # (d) a forged pair: the combined check fails, bisection runs two oracles
    with RlcCase("forged_pair", eng, counters, "fp_mont_mul") as case:
        t0 = time.perf_counter()
        handle = eng.dispatch(MSG, pair)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        got = eng.fetch(handle)
    case.fig["combined_dispatch_ms"] = dispatch_ms
    case.check(got, [True, False], rlc_launches=1, bisection_ct=2, bisection_depth_max=1,
               engine_launches=3, miller_lanes=2)
    cases["forged_pair"] = case.fig

    # (e) 6b without RLC: one per-candidate launch over four messages
    with RlcCase("multi_msg", base, counters, "fp_mont_mul") as case:
        items = [(m, pks, bs, sig) for m, (reqs, _) in zip(session_msgs, mixed)
                 for bs, sig in reqs]
        got = base.fetch(base.dispatch_multi(items))
    case.check(got, [e for _, exp in mixed for e in exp], multi_msg_launches=1,
               engine_launches=1)
    cases["multi_msg"] = case.fig

    # (f) one honest RLC range launch on the rns backend
    reng = BN254Device(bank=rbase.bank, batch_size=LANES, curves=rcons.curves,
                       batch_check="rlc", rlc_rng=random.Random(SEED + 1))
    with RlcCase("range_rns", reng, counters, "rns_mont_mul_resident") as case:
        got = reng.fetch(reng.dispatch(MSG, range_reqs))
    case.check(got, range_expect, rlc_launches=1, bisection_ct=0, miller_lanes=2,
               final_exp_lanes=1, engine_launches=1)
    cases["range_rns"] = case.fig

    seconds = time.perf_counter() - t_phase
    launches = {k: c.launches for k, c in counters.items()}
    # each case's sum of B1's and B2's bounds over its calls, by width
    bound = {"fp_mont_mul": lambda c: mont_mul_bound_ms(16, c)[0],
             "rns_mont_mul_resident": lambda c: rns_bound_ms(rcons.curves.F, c)[0]}
    for case in cases.values():
        case["bound_ms"] = {k: sum(n * bound[k](int(cols)) for cols, n in w.items())
                            for k, w in case["widths"].items()}
    fig = {
        "cases": cases, "seconds": seconds, "kernel_launches": launches,
        "bound_ms_by_case": {name: c["bound_ms"] for name, c in cases.items()},
        "widths": width_histograms(counters),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "per_candidate_p50_ms": p50_ms,
        "wall_over_per_candidate_p50": {
            name: cases[name]["wall_ms"] / p50_ms[key]
            for name, key in (("dense", "cios_dense"), ("range_rns", "rns_range"))},
        "wall_over_case_e": {
            name: cases[name]["wall_ms"] / cases["multi_msg"]["wall_ms"]
            for name in ("dense", "service", "forged_pair")},
    }
    line("rlc_summary", **{k: v for k, v in fig.items() if k != "cases"})
    return fig


def path_widths_check(F24, R65, widths: dict) -> dict:
    """B1 on the 24-limb field `F24` and B2 on the 65-residue field `R65`
    against their plain versions, exactly, at every column count of
    `widths` ({"cios": B1's {cols: calls}, "rns": B2's}): seeded canonical
    operands (B1's led by the edge pairs), residues with 0 and m_i - 1
    first (B2's). Returns {kernel/rows: widths checked}. Raises on any
    difference."""
    import torch

    rng = np.random.default_rng(BLS_SEED)
    out = {}
    for F, cols_of, fn, plain, name in (
            (F24, widths["cios"], F24.mul, F24._mul_plain, "fp_mont_mul/24"),
            (R65, widths["rns"], R65.mul_resident, R65._mul_resident_core,
             "rns_mont_mul_resident/65")):
        for cols in sorted(int(c) for c in cols_of):
            if F is F24:
                a, b = operand_pair(F, cols, rng, with_edges=cols >= 16)
            else:
                a, b = random_residues(F, cols, rng), random_residues(F, cols, rng)
            a, b = a.to(F.device), b.to(F.device)
            if not torch.equal(fn(a, b), plain(a, b)):
                raise AssertionError(f"{name} != plain at phase 11's width {cols}")
        out[name] = sorted(int(c) for c in cols_of)
    torch.cuda.synchronize()
    line("bls12_381_widths", checked=out, max_abs_err=0)
    return out


def bls_phase(dev, counters) -> dict:
    """Phase 11: BLS12-381 through `new_scheme("bls12-381-cuda")` at the
    repo's shape for it (module docstring). Each backend's launches are one
    main-path run: every count set to 0 just before them and read just
    after. Raises on any failed check; returns the figures."""
    import torch

    from handel_tpu_torch.models.bls12_381_torch import BLS12381Device, BLS12381TorchScheme
    from handel_tpu_torch.models.registry import new_scheme

    t_phase = time.perf_counter()
    family = BLS12381Device
    ref = family.ref
    prng = random.Random(BLS_SEED)
    t0 = time.perf_counter()
    sks, pks = make_registry(BLS_REGISTRY, prng, family)
    reqs = {
        "range": make_requests("range", sks, BLS_RANGE_CANDIDATES, prng, family,
                               max_holes=BLS_MAX_HOLES),
        "dense": make_requests("dense", sks, BLS_DENSE_CANDIDATES, prng, family),
    }
    line("bls12_381_setup", registry=BLS_REGISTRY, host_keygen_s=time.perf_counter() - t0)
    # backend: (its kernel, that kernel's rows at 381 bits, launch classes)
    paths = {"cios": ("fp_mont_mul", 24, ("range", "dense")),
             "rns": ("rns_mont_mul_resident", 65, ("range",))}
    cons_of, figs = {}, {}
    for backend, (kernel, rows, classes) in paths.items():
        scheme = new_scheme("bls12-381-cuda", batch_size=BLS_LANES, device=dev,
                            fp_backend=backend)
        if not isinstance(scheme, BLS12381TorchScheme):
            raise AssertionError(f"bls12-381-cuda built a {type(scheme).__name__}")
        cons = cons_of[backend] = scheme.constructor
        bound = ((lambda c: mont_mul_bound_ms(24, c)[0]) if backend == "cios"
                 else (lambda c, F=cons.curves.F: rns_bound_ms(F, c)[0]))
        t0 = time.perf_counter()
        engine = cons.prepare(pks)  # registry commit, warmup launch, prefix table
        torch.cuda.synchronize(dev)
        prepare_s = time.perf_counter() - t0
        for kind in classes:
            if engine._pack_requests(reqs[kind][0]).kind != kind:
                raise AssertionError(f"bls12_381 {kind} requests packed as another class")
        zero_counts(counters)  # the main path: counts zeroed just before
        per_launch = {}
        for kind in classes:
            requests, expect = reqs[kind]
            torch.cuda.reset_peak_memory_stats(dev)
            before = snapshot(counters)
            t0 = time.perf_counter()
            got = cons.batch_verify(MSG, pks, requests)
            wall_ms = (time.perf_counter() - t0) * 1e3
            if got != expect:
                bad = [j for j, (g, e) in enumerate(zip(got, expect)) if g != e]
                raise AssertionError(f"bls12_381 {backend} {kind} verdicts wrong at lanes {bad}")
            delta = moved(counters, before)
            calls = delta.get(kernel, {"widths": {}})["widths"]
            per_launch[kind] = {
                "wall_ms": wall_ms, "candidates": len(requests),
                "kernel_launches": {k: v["launches"] for k, v in delta.items()},
                "widths": calls, "rows": delta.get(kernel, {}).get("rows", {}),
                "bound_ms": sum(n * bound(int(c)) for c, n in calls.items()),
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            }
            line("bls12_381", path=backend, launch_class=kind, lanes=BLS_LANES,
                 registry=BLS_REGISTRY, verdicts_ok=True, **per_launch[kind])
        launches = {k: c.launches for k, c in counters.items()}  # read just after
        if launches[kernel] == 0:
            raise AssertionError(f"the bls12_381 {backend} path never launched {kernel}")
        for k in counters:
            if k != kernel and launches[k] != 0:
                raise AssertionError(
                    f"the bls12_381 {backend} path launched {k} {launches[k]} times")
        if dict(counters[kernel].rows) != {rows: launches[kernel]}:
            raise AssertionError(f"bls12_381 {backend}: {kernel} ran at rows "
                                 f"{dict(counters[kernel].rows)}, expected only {rows}")
        figs[backend] = {"prepare_s": prepare_s, "launches": launches,
                         "widths": {str(c): n for c, n in sorted(counters[kernel].widths.items())},
                         "bound_ms": sum(v["bound_ms"] for v in per_launch.values()),
                         "per_launch": per_launch}

    # the oracle pairing on each engine's own curves, then the combine
    for backend, cons in cons_of.items():
        pairing_phase(dev, backend, family, curves=cons.curves)
    crng = random.Random(BLS_SEED)
    pts = [ref.g1_mul(ref.G1_GEN, crng.randrange(1, ref.R)) for _ in range(8)]
    combine = {}
    for backend, cons in cons_of.items():
        engine = cons._device
        if engine._combine_curves.F.backend != "cios":
            raise AssertionError(f"the bls12_381 {backend} engine combines off the cios field")
        before = snapshot(counters)
        for k in (2, 4, 8):
            groups = [[pts[(j + i) % 8] for i in range(k - j % 2)] for j in range(6)]
            groups[0] = [pts[0], ref.g1_neg(pts[0])] + groups[0][2:]
            want = []
            for g in groups:
                acc = None
                for q in g:
                    acc = ref.g1_add(acc, q)
                want.append(acc)
            if engine.combine_batch(groups) != want:
                raise AssertionError(f"bls12_381 {backend} combine class {k} != the oracle's sums")
        c = combine[backend] = moved(counters, before)
        if set(c) != {"fp_mont_mul"} or c["fp_mont_mul"]["rows"] != {
                "24": c["fp_mont_mul"]["launches"]}:
            raise AssertionError(f"bls12_381 {backend} combine: B1 alone at 24 limbs, got {c}")
    checked = path_widths_check(cons_of["cios"].curves.F, cons_of["rns"].curves.F,
                                {b: f["widths"] for b, f in figs.items()})
    fig = {"paths": figs, "combine": combine, "checked_widths": checked,
           "seconds": time.perf_counter() - t_phase}
    line("bls12_381_summary", **{
        "seconds": fig["seconds"],
        "walls_ms": {f"{b}_{kind}": v["wall_ms"] for b, f in figs.items()
                     for kind, v in f["per_launch"].items()},
        "prepare_s": {b: f["prepare_s"] for b, f in figs.items()},
        "kernel_launches": {b: f["launches"] for b, f in figs.items()},
        "bound_ms": {b: f["bound_ms"] for b, f in figs.items()},
        "combine_kernel_launches": {b: {k: v["launches"] for k, v in c.items()}
                                    for b, c in combine.items()},
        "nvidia_smi": nvidia_smi()})
    return fig


def mesh_requests(kind: str, sks, prng, forged: int):
    """MESH_BATCH honest candidates of `kind` with lane `forged`'s signature
    moved off its aggregate by one generator: (requests, expected)."""
    from handel_tpu_torch.models.bn254_torch import BN254Device

    reqs, expect = make_requests(kind, sks, MESH_BATCH, prng, BN254Device, honest=True)
    bs, sig = reqs[forged]
    reqs[forged] = (bs, BN254Device.Signature(BN254Device.ref.g1_add(sig.point,
                                                                       BN254Device.ref.G1_GEN)))
    expect[forged] = False
    return reqs, expect


def mesh_phase(cons, pks, sks, counters, prng, p50_ms) -> dict:
    """Phase 16: the mesh on the card, as one main-path run. (a) One
    `bn254_mesh_engine(pks, devices=2)` over phase 4's curves and registry
    makes one range and one dense launch of MESH_BATCH candidates, a forged
    one in each: verdicts as known, the dense launch's sharded aggregate
    (affine) equal to phase 4's single-card masked sum of the same mask,
    B1 inside each launch (by card), `mesh_launches` 2. (b) The same engine
    as the mesh lane (`enable_latency_plane`) of a service whose throughput
    lane is phase 4's engine: a gold-tier group of MESH_BATCH rides the mesh
    (meshLaunches + 1, span `launch_on_mesh`), then a standard-tier group of
    RANGE_CANDIDATES stays on the card's lane; verdicts exact, no fallback,
    no open breaker. Returns the figures."""
    import asyncio

    import torch

    from handel_tpu_torch.core.trace import FlightRecorder
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.parallel.batch_verifier import BatchVerifierService
    from handel_tpu_torch.parallel.mesh_plane import (
        ModePolicy,
        bn254_mesh_engine,
        enable_latency_plane,
    )
    from handel_tpu_torch.parallel.sharding import make_mesh

    engine = cons._device  # phase 4's engine: 4096 keys, 128 lanes, cios
    cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(MESH_SHARDS)]
               if cards >= MESH_SHARDS else [torch.device("cuda", 0)] * MESH_SHARDS)
    placement = ("one shard a card" if cards >= MESH_SHARDS
                 else f"{MESH_SHARDS} shards on cuda:0 ({cards} card visible)")
    mesh = make_mesh(MESH_SHARDS, devices=devices)
    t0 = time.perf_counter()
    eng = bn254_mesh_engine(pks, MESH_SHARDS, batch_size=MESH_BATCH, curves=cons.curves,
                            mesh=mesh)
    build_s = time.perf_counter() - t0
    range_reqs = mesh_requests("range", sks, prng, MESH_FORGED_RANGE)
    dense_reqs = mesh_requests("dense", sks, prng, MESH_FORGED_DENSE)
    gold_reqs = mesh_requests("range", sks, prng, MESH_FORGED_RANGE)
    std_reqs = make_requests("range", sks, RANGE_CANDIDATES, prng, cons.Device)
    for kind, (reqs, _) in (("range", range_reqs), ("dense", dense_reqs),
                            ("range", gold_reqs)):
        if eng._pack_requests(reqs).kind != kind:
            raise AssertionError(f"phase 16: {kind} requests packed as another class")
    # the dense launch's sharded aggregate, kept for the single-card check
    aggs = []
    sharded_sum = eng._sharded_sum

    def keep_aggregate(*args):
        aggs.append(sharded_sum(*args))
        return aggs[-1]

    eng._sharded_sum = keep_aggregate

    rec = FlightRecorder(capacity=1 << 16)
    svc = BatchVerifierService(engine, fallback=None, max_inflight=2, recorder=rec)
    enable_latency_plane(svc, eng, policy=ModePolicy(small_batch_max=MESH_BATCH))
    svc.queue.set_tier("gold0", "gold")

    async def through_service():
        try:
            t0 = time.perf_counter()
            gold = await svc.verify(MSG, pks, gold_reqs[0], session="gold0")
            gold_s = time.perf_counter() - t0
            mid = svc.values()
            t0 = time.perf_counter()
            std = await svc.verify(MSG, pks, std_reqs[0], session="std0")
            return gold, std, gold_s, time.perf_counter() - t0, mid, svc.values()
        finally:
            svc.stop()

    # the main path: counts zeroed just before, read just after
    torch.cuda.synchronize()
    zero_counts(counters)
    launches = {}
    for kind, (reqs, expect) in (("range", range_reqs), ("dense", dense_reqs)):
        before = snapshot(counters)
        by_card = dict(mont_mul.devices)
        t0 = time.perf_counter()
        got = eng.fetch(eng.dispatch(MSG, reqs))
        wall_ms = (time.perf_counter() - t0) * 1e3
        delta = moved(counters, before)
        launches[kind] = {
            "wall_ms": wall_ms, "phase4_p50_ms": p50_ms[kind],
            "kernel_launches": {k: d["launches"] for k, d in delta.items()},
            "b1_by_card": {str(d): n - by_card.get(d, 0)
                           for d, n in sorted(mont_mul.devices.items())
                           if n != by_card.get(d, 0)},
            "verdicts_ok": got == expect,
        }
        if got != expect:
            bad = [j for j, (g, e) in enumerate(zip(got, expect)) if g != e]
            raise AssertionError(f"phase 16 mesh {kind} launch: verdicts wrong at lanes {bad}")
    direct_launches = eng.mesh_launches
    gold, std, gold_s, std_s, mid, values = asyncio.run(through_service())
    total = {k: c.launches for k, c in counters.items()}
    widths = width_histograms(counters)
    b1_by_card = {str(d): n for d, n in sorted(mont_mul.devices.items())}
    eng._sharded_sum = sharded_sum

    # checks
    for kind, fig in launches.items():
        if fig["kernel_launches"].get("fp_mont_mul", 0) == 0:
            raise AssertionError(f"phase 16: no B1 launch inside the mesh {kind} launch")
        if cards >= MESH_SHARDS and len(fig["b1_by_card"]) != MESH_SHARDS:
            raise AssertionError(f"phase 16 {kind}: B1 by card {fig['b1_by_card']}")
    for k in ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"):
        if total[k]:
            raise AssertionError(f"phase 16 launched {k} {total[k]} times")
    if gold != gold_reqs[1]:
        raise AssertionError(f"phase 16 gold group verdicts {gold} != {gold_reqs[1]}")
    if std != std_reqs[1]:
        bad = [j for j, (g, e) in enumerate(zip(std, std_reqs[1])) if g != e]
        raise AssertionError(f"phase 16 standard group verdicts wrong at lanes {bad}")
    if (direct_launches, eng.mesh_launches) != (2, 3) or mid["meshLaunches"] != 1.0 \
            or values["meshLaunches"] != 1.0:
        raise AssertionError(f"phase 16: mesh launches {direct_launches} then "
                             f"{eng.mesh_launches}, the service's {mid['meshLaunches']} / "
                             f"{values['meshLaunches']}")
    if values["modeLatencyLaunches"] != 1.0 or values["modeThroughputLaunches"] < 1.0:
        raise AssertionError(f"phase 16: mode launches {values['modeLatencyLaunches']} / "
                             f"{values['modeThroughputLaunches']}")
    if values["meshFallbacks"] != 0.0 or values["meshLanesAvailable"] != 1.0:
        raise AssertionError(f"phase 16: mesh fallbacks {values['meshFallbacks']}, "
                             f"available {values['meshLanesAvailable']}")
    service_checks("phase 16 service", values)
    spans = [ev for ev in rec.events() if ev[1] == "X" and ev[0].startswith("launch_on_")]
    gold_spans = [ev for ev in spans if (ev[6] or {}).get("sessions") == "gold0"]
    std_spans = [ev for ev in spans if (ev[6] or {}).get("sessions") == "std0"]
    if [ev[0] for ev in gold_spans] != ["launch_on_mesh"] or not std_spans or any(
            ev[0] != "launch_on_device" for ev in std_spans):
        raise AssertionError(f"phase 16 spans: gold {[ev[0] for ev in gold_spans]}, "
                             f"standard {[ev[0] for ev in std_spans]}")

    # the dense launch's sharded aggregate against phase 4's single-card
    # masked sum of the same mask (outside the main path's counts)
    (agg,) = aggs
    n, C = len(pks), MESH_BATCH
    mask = np.zeros((n, C), bool)
    for j, (bs, _) in enumerate(dense_reqs[0]):
        mask[list(bs.indices()), j] = True
    g2, T = cons.curves.g2, cons.curves.T
    tile = lambda a: a.repeat_interleave(C, dim=1)  # noqa: E731
    (x0, x1), (y0, y1) = engine.bank.reg_x, engine.bank.reg_y
    single = g2.masked_sum(
        g2.from_affine((tile(x0), tile(x1)), (tile(y0), tile(y1))),
        torch.from_numpy(mask.reshape(-1)).to(engine.device), n)
    affine = []
    for pt in (agg, single):
        x, y, inf = g2.to_affine(pt)
        affine.append((T.f2_unpack(x), T.f2_unpack(y), inf.cpu().tolist()))
    if affine[0] != affine[1] or any(affine[0][2]):
        raise AssertionError("phase 16: the sharded dense aggregate != the single-card sum")

    fig = {
        "shards": MESH_SHARDS, "devices": [str(d) for d in devices], "placement": placement,
        "batch": MESH_BATCH, "registry": n,
        "build_s": build_s, "launches": launches,
        "dense_aggregate_equals_single_card": True,
        "service": {"gold_wall_ms": gold_s * 1e3, "standard_wall_ms": std_s * 1e3,
                    "gold_span_ms": gold_spans[0][3] * 1e3,
                    "standard_span_ms": [ev[3] * 1e3 for ev in std_spans],
                    "meshLaunches": values["meshLaunches"],
                    "modeLatencyLaunches": values["modeLatencyLaunches"],
                    "modeThroughputLaunches": values["modeThroughputLaunches"],
                    "meshFallbacks": values["meshFallbacks"]},
        "mesh_launches": {"direct": direct_launches, "after_service": eng.mesh_launches},
        "mesh_candidates": eng.mesh_candidates,
        "kernel_launches": total, "b1_by_card": b1_by_card, "widths": widths,
    }
    line("mesh", **fig)
    return fig


def stages_phase(cons, rcons, requests, expect, counters) -> dict:
    """Phase 17, one main-path run a backend: the stage profile of phase 4's
    range launch on its cios and rns engines (module docstring). Raises on
    a wrong verdict, a launch sum that does not hold, or a kernel where it
    must not run; returns the figures by backend."""
    from handel_tpu_torch.scripts.verify_profile import STAGES, profile

    t_phase = time.perf_counter()
    want = list(expect) + [False] * (LANES - len(expect))
    figs = {}
    # the stages that run the backend's kernel: on rns the aggregation and
    # the affine step run the per-mul RNS product (ops/rns.py RnsField.mul,
    # plain torch), and only the resident pairing runs B2
    for label, c, kernel, on_kernel in (
            ("cios", cons, "fp_mont_mul", STAGES),
            ("rns", rcons, "rns_mont_mul_resident", ("miller_loop_2c", "final_exp"))):
        engine = c._device
        zero_counts(counters)
        rec, composed, full = profile(engine, requests, engine._h_point(MSG), STAGE_TRIALS,
                                      depth=STAGE_DEPTH, pipelined_trials=1, warm=False)
        launches = {k: n.launches for k, n in counters.items()}
        if composed != full:
            bad = [j for j, (a, b) in enumerate(zip(composed, full)) if a != b]
            raise AssertionError(f"phase 17 {label}: composed stages != full launch at lanes {bad}")
        if full != want:
            bad = [j for j, (a, b) in enumerate(zip(full, want)) if a != b]
            raise AssertionError(f"phase 17 {label}: verdicts wrong at lanes {bad}")
        if any(rec["launch_sum"]["difference"].values()):
            raise AssertionError(f"phase 17 {label}: stage launches do not add up to the "
                                 f"full launch's: {rec['launch_sum']}")
        for stage in STAGES:
            got = rec["launches"][stage]
            if (got[kernel] > 0) != (stage in on_kernel) or any(
                    n for k, n in got.items() if k != kernel):
                raise AssertionError(f"phase 17 {label}: {stage} launched {got}")
        # the other backend's kernel, and the lab's, run nowhere here
        idle = [k for k in counters if k != kernel and launches[k]]
        if launches[kernel] == 0 or idle:
            raise AssertionError(f"phase 17 {label}: kernel launches {launches}")
        figs[label] = {"launches": launches[kernel], "record": rec}
        line("stages", path=label, lanes=LANES, candidates=len(expect),
             registry=N_REGISTRY, verdicts_ok=True, composed_equals_full=True,
             stage_p50_ms={s: rec[f"{s}_ms"] for s in STAGES},
             stage_sum_ms=rec["stage_sum_ms"], full_launch_ms=rec["full_launch_ms"],
             stage_sum_over_full_launch=rec["stage_sum_over_full_launch"],
             pipelined_depth=rec["pipelined_depth"],
             pipelined_per_launch_ms=rec["pipelined_per_launch_ms"],
             pipelined_over_full_launch=rec["pipelined_over_full_launch"],
             dispatch_rt_ms=rec["dispatch_rt_ms"],
             launches_by_stage={s: rec["launches"][s][kernel] for s in
                                (*STAGES, "full_launch")},
             launch_sum=rec["launch_sum"], kernel_launches=launches,
             trials=STAGE_TRIALS)
    figs["seconds"] = time.perf_counter() - t_phase
    return figs


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.lab_mont import lab_cios_fullwidth, lab_separated
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident

    return {"fp_mont_mul": mont_mul, "rns_mont_mul_resident": rns_mul_resident,
            "lab_cios_fullwidth": lab_cios_fullwidth, "lab_separated": lab_separated}


def worker_phases(dev, counters, clock: PhaseClock) -> dict:
    """WORKER_PHASES, in order, each timed by `clock`; returns their
    figures by phase."""
    import torch

    figs = {"round": round_phase(dev, counters)}
    clock("round")
    figs["service_round"] = service_round_phase(
        dev, counters, "cios", "round", "fp_mont_mul",
        ("rns_mont_mul_resident", "lab_cios_fullwidth", "lab_separated"))
    clock("service_round")
    figs["service_round_rns"] = service_round_phase(
        dev, counters, "rns", "round_rns", "rns_mont_mul_resident",
        ("lab_cios_fullwidth", "lab_separated"), nodes=SERVICE_ROUND_NODES_RNS)
    clock("service_round_rns")
    for name, phase in (("sim", sim_phase), ("adversarial", adversarial_phase),
                        ("fleet", fleet_phase), ("weighted", weighted_phase)):
        torch.cuda.empty_cache()  # the sim's node processes share the card
        figs[name] = phase()
        clock(name)
    torch.cuda.empty_cache()
    figs["bls12_381"] = bls_phase(dev, counters)
    clock("bls12_381")
    assert tuple(figs) == WORKER_PHASES
    return figs


def worker_main(out_dir: str) -> int:
    """`chip_smoke.py --worker OUT_DIR`, the script's second process:
    WORKER_PHASES on the kernels the first process built, their lines on
    standard output, their figures and seconds in OUT_DIR/figures.json."""
    import torch

    clock = PhaseClock()
    figs = worker_phases(torch.device("cuda", 0), kernel_counters(), clock)
    with open(os.path.join(out_dir, "figures.json"), "w") as f:
        json.dump({"figures": figs, "seconds": clock.seconds}, f)
    return 0


def start_worker(out_dir: str) -> subprocess.Popen:
    """Starts the second process in a session of its own, its standard
    output and error in files under `out_dir`."""
    here = Path(__file__).resolve()
    with open(os.path.join(out_dir, "worker.out"), "w") as out, \
            open(os.path.join(out_dir, "worker.err"), "w") as err:
        return subprocess.Popen([sys.executable, str(here), "--worker", out_dir],
                                cwd=here.parent, stdout=out, stderr=err,
                                start_new_session=True)


def stop_worker(proc: subprocess.Popen) -> None:
    """Stops the second process if it still runs: SIGTERM first, which it
    turns into SystemExit, so that its running sim stops its node processes
    (sim_run's and fleet_phase's `finally`); then SIGKILL to its group."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=WORKER_STOP_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def check_worker(proc: subprocess.Popen, out_dir: str) -> None:
    """Raises, with the end of its standard error, if the second process
    has ended with a code other than 0."""
    if proc.poll() not in (None, 0):
        with open(os.path.join(out_dir, "worker.err")) as f:
            err = f.read()
        raise AssertionError(f"the second process ({', '.join(WORKER_PHASES)}) exited "
                             f"{proc.returncode}:\n{err[-6000:]}")


def join_worker(proc: subprocess.Popen, out_dir: str, deadline: float) -> dict:
    """Waits for the second process until `deadline` (time.perf_counter()),
    stopping it then; prints its lines and returns its figures and seconds.
    Raises if it failed or did not end in time."""
    try:
        proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        late = False
    except subprocess.TimeoutExpired:
        stop_worker(proc)
        late = True
    with open(os.path.join(out_dir, "worker.out")) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    if late:
        raise AssertionError(f"the second process ({', '.join(WORKER_PHASES)}) still ran "
                             f"{WORKER_DEADLINE_S} s after the start")
    check_worker(proc, out_dir)
    with open(os.path.join(out_dir, "figures.json")) as f:
        return json.load(f)


def main(argv: list[str] | None = None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    # a SIGTERM, from the caller or from the first process, unwinds through
    # every `finally`, and so stops the processes this one started
    signal.signal(signal.SIGTERM, lambda signum, _frame: sys.exit(128 + signum))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--worker":
        return worker_main(argv[1])
    if argv:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_worker_") as worker_dir:
        workers: list[subprocess.Popen] = []
        try:
            return first_process(worker_dir, workers)
        finally:
            for proc in workers:
                stop_worker(proc)


def first_process(worker_dir: str, workers: list) -> int:
    """The script's first process: phases 1-6, then the second process
    (WORKER_PHASES, started into `workers`, its files in `worker_dir`)
    beside phases 4, 5, 16, 17, 8's load, 10, 12's RPC and ban cases and
    14; then the kernels line and the result."""
    import torch

    from handel_tpu_torch.kernels import build
    from handel_tpu_torch.kernels.fp_mont import mont_mul
    from handel_tpu_torch.kernels.rns_mont import SUPPORTED_BASES as RNS_BASES
    from handel_tpu_torch.kernels.rns_mont import TILES as RNS_TILES
    from handel_tpu_torch.kernels.rns_mont import rns_mul_resident
    from handel_tpu_torch.models.bn254_torch import BN254Device, BN254TorchScheme
    from handel_tpu_torch.ops import bn254_ref as bn
    from handel_tpu_torch.ops.fp import Field

    clock = PhaseClock()
    t_start = clock.start

    def done(phase: str) -> None:
        """Seconds since the previous phase ended, under `phase`; raises
        if the second process has failed meanwhile."""
        clock(phase)
        for proc in workers:
            check_worker(proc, worker_dir)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    line("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    done("device")

    t0 = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for src, (_secs, log) in built.items():
        ptxas[src] = ptxas_summary(log)
        for fn, (regs, st, ld, smem) in ptxas[src].items():
            print(f"  nvcc {src}: {fn}: {regs} registers, {st} bytes spill stores, "
                  f"{ld} bytes spill loads, {smem} bytes static shared memory")
    # kernel B2: its tiles' dynamic shared memory, and its int8 tensor-core
    # products (IMMA) in the built SASS; every B1 and B2 instance spill-free
    import ctypes

    smem_of = ctypes.CDLL(str(build.library_path("rns_mont"))).handel_rns_smem_bytes
    dyn_smem = {f"rns_mul_resident_kernel<{ka},{kb},{tile}>": smem_of(ka, kb, tile)
                for ka, kb in RNS_BASES for tile in RNS_TILES}
    imma = {k: n for k, n in sass_counts(build.library_path("rns_mont"), "IMMA").items()
            if k.startswith("rns_mul_resident_kernel")}
    line("build", seconds=seconds, sources=sorted(built), ptxas=ptxas,
         dynamic_smem=dyn_smem, imma=imma)
    if sorted(imma) != sorted(dyn_smem) or not all(imma.values()):
        raise AssertionError(f"a B2 instance without IMMA instructions: {imma}")
    for src in ("fp_mont", "rns_mont"):
        if not ptxas[src]:
            raise AssertionError(f"no ptxas report for {src}: spills cannot be checked")
        for fn, (_regs, st, ld, _smem) in ptxas[src].items():
            if st or ld:
                raise AssertionError(f"{fn} spills ({st} bytes stored, {ld} loaded)")
    done("build")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    F16 = Field(bn.P, device=dev)
    F24 = Field(BLS12_381_P, device=dev)
    f12_width = 54 * 2 * LANES  # f12_mul over the 2C Miller lanes of a launch
    # the dense class's first tree-sum stage adds two halves of N*C points;
    # its second stacked multiply is 6 Fp2 products, 3 base products each
    widest = 9 * N_REGISTRY * LANES
    R46 = Field(bn.P, backend="rns", device=dev)
    R65 = Field(BLS12_381_P, backend="rns", device=dev)
    ragged_phase((F16, F24), (R46, R65), rng)
    done("ragged")
    # phase 14's staging: the prefix scan's widest stacked multiply (18n
    # columns, a G2 add's 6 Fp2 products of 3 base products each)
    scan_width = 18 * N_REGISTRY
    k16 = kernel_phase(
        F16, {"random+edges": (1 << 20) + 16, "f12_mul": f12_width, "g2_add_dense": widest,
              "g2_add_scan": scan_width},
        rng, with_edges=True,
    )
    k24 = kernel_phase(F24, {"random+edges": (1 << 20) + 16, **BLS_B1_WIDTHS}, rng,
                       with_edges=True)
    done("kernel")
    r46 = rns_kernel_phase(R46, {"random+edges": (1 << 20) + 16, "f12_mul": f12_width}, rng)
    r65 = rns_kernel_phase(R65, {"random+edges": (1 << 20) + 16, **BLS_B2_WIDTHS}, rng)
    done("rns_kernel")
    b3 = lab_kernel_phase(
        F16, {"random+edges": (1 << 20) + 16, "lab_batch": 1 << 18, "f12_mul": f12_width}, rng,
        timed=("random+edges", "lab_batch"),
    )
    b3_24 = lab_kernel_phase(F24, {"random+edges": (1 << 20) + 16}, rng, timed=("random+edges",))
    for kname in b3:
        b3[kname].update(b3_24[kname])
    # B3a and B3b as built: instructions per column, the tensor-core (IMMA)
    # and dot-product (IDP) ones among them, and B3b's shared memory
    lab_smem = ctypes.CDLL(str(build.library_path("lab_mont"))).handel_lab_smem_bytes
    lab_sass = sass_profile(build.library_path("lab_mont"))
    if lab_sass is None:
        line("lab_kernel", sass="not read: the CUDA toolkit has no cuobjdump")
    else:
        for kname, prof in sorted(lab_sass.items()):
            line("lab_kernel", sass=kname, per_column=prof)
            if kname.startswith("lab_separated_kernel") and not prof["IMMA"]:
                raise AssertionError(f"{kname}: no IMMA (int8 tensor-core) instruction")
            if not prof["IDP"]:
                raise AssertionError(f"{kname}: no IDP (dp4a) instruction")
    line("lab_kernel", dynamic_smem={f"lab_separated_kernel<{n},{w}>": lab_smem(n, w)
                                     for n in (16, 24) for w in (1, 2, 4)})
    done("lab_kernel")

    pairing_phase(dev, "cios", BN254Device)
    pairing_phase(dev, "rns", BN254Device)
    done("pairing")
    counters = kernel_counters()
    lab = lab_phase(dev, counters)
    done("lab")
    # the second process starts once phase 3's and 6's timings are taken:
    # the card runs both processes' launches from here on
    workers.append(start_worker(worker_dir))

    prng = random.Random(SEED)
    t0 = time.perf_counter()
    sks, pks = make_registry(N_REGISTRY, prng, BN254Device)
    reqs = {
        "range": make_requests("range", sks, RANGE_CANDIDATES, prng, BN254Device),
        "dense": make_requests("dense", sks, DENSE_CANDIDATES, prng, BN254Device),
    }
    line("setup", registry=N_REGISTRY, host_keygen_s=time.perf_counter() - t0)
    done("setup")
    cons = BN254TorchScheme(batch_size=LANES, device=dev).constructor
    cios, cios_p50 = verify_path("cios", cons, pks, reqs, counters, "fp_mont_mul",
                                 ("rns_mont_mul_resident", "lab_cios_fullwidth",
                                  "lab_separated"))
    done("verify")
    rcons = BN254TorchScheme(batch_size=LANES, device=dev, fp_backend="rns").constructor
    rns, rns_p50 = verify_path("rns", rcons, pks, reqs, counters, "rns_mont_mul_resident",
                               ("fp_mont_mul", "lab_cios_fullwidth", "lab_separated"),
                               conv_field=rcons.curves.F)
    done("rns_verify")
    on_path = {
        "fp_mont_mul": profile_phase(cons, pks, reqs["range"][0], "mont_mul_kernel", "cios",
                                     mont_mul, lambda c: mont_mul_bound_ms(16, c)),
        "rns_mont_mul_resident": profile_phase(
            rcons, pks, reqs["range"][0], "rns_mul_resident_kernel", "rns", rns_mul_resident,
            lambda c: rns_bound_ms(rcons.curves.F, c)),
    }
    done("profile")
    # phase 16 runs here: phase 14 later rotates phase 4's engine off the
    # registry phase 16 uses
    mesh = mesh_phase(cons, pks, sks, counters, prng, cios_p50)
    done("mesh")
    stages = stages_phase(cons, rcons, *reqs["range"], counters)
    done("stages")
    load = service_load_phase(cons, pks, sks, counters, prng)
    done("service_load")
    rlc = rlc_phase(cons, rcons, sks, pks, counters, prng, {
        "cios_range": cios_p50["range"], "cios_dense": cios_p50["dense"],
        "rns_range": rns_p50["range"]})
    done("rlc")
    rpc = rpc_phase(cons, pks, sks, counters, prng)
    done("rpc")
    ban = ban_case(cons, pks, sks, counters)
    done("ban")
    life = lifecycle_phase(cons, pks, sks, counters)
    done("lifecycle")
    joined = join_worker(workers[0], worker_dir, t_start + WORKER_DEADLINE_S)
    done("wait_for_second_process")
    rnd, srnd, srnd_rns, sim, adv, fleet, weighted, bls = (
        joined["figures"][name] for name in WORKER_PHASES)
    on_service = {
        key: {"launches": f["kernel_launches"]["fp_mont_mul"],
              "widths": f["widths"].get("fp_mont_mul", {})}
        for key, f in (("load", load), ("round", srnd), ("round_rns", srnd_rns))
    }

    def on_rlc(kname):
        """The kernel's launches in phase 10, in all and by case, and its
        calls by column count on each case that launched it."""
        return {"launches": rlc["kernel_launches"][kname],
                "by_case": {name: {"launches": c["kernel_launches"][kname],
                                   "widths": c["widths"].get(kname, {}),
                                   "bound_ms": c["bound_ms"].get(kname)}
                            for name, c in rlc["cases"].items()
                            if c["kernel_launches"][kname]}}

    def on_bls(kname, backend, at_widths):
        """The kernel's launches on phase 11's path of its backend, its calls
        by column and row count there and the sum of their bounds; phase 3's
        figures at phase 11's main widths (`at_widths`), and the widths at
        which phase 11 held it to its plain version."""
        f = bls["paths"][backend]
        return {"launches": f["launches"][kname], "widths": f["widths"],
                "rows": {k: v["rows"] for k, v in f["per_launch"].items()},
                "bound_ms": f["bound_ms"],
                "at_widths": {label: {k: fig[k] for k in (
                    "cols", "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by")}
                    for label, fig in at_widths.items() if label.startswith("bls_")},
                "checked_widths": next(v for k, v in bls["checked_widths"].items()
                                       if k.startswith(kname))}

    def on_stages(backend):
        """The kernel's launches in phase 17 on its backend, in all and by
        stage (the full launch's beside them)."""
        rec = stages[backend]["record"]
        return {"launches": stages[backend]["launches"],
                "by_stage": {s: n[rec["kernel"]] for s, n in rec["launches"].items()}}

    def entry(kname, source, replaces, launches, widths, fig, **extra):
        return {
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in widths),
            "ms": fig["ms"], "eager_ms": fig["eager_ms"], "plain_ms": fig["plain_ms"],
            "bound_ms": fig["bound_ms"], "bound_by": fig["bound_by"],
            "library_ms": None, "cols": fig["cols"], **extra,
        }

    # B1 and B2 at the Fp12 width of their verify path, with their launches
    # there; B3a and B3b at 2^20 + 16 columns of 16 limbs, with the launches
    # they executed in the lab run (captured calls beside them)
    print(json.dumps({"kernels": [
        entry("fp_mont_mul", "handel_tpu_torch/csrc/fp_mont.cu", "handel_tpu/ops/fp.py:577",
              cios["fp_mont_mul"], [*k16.values(), *k24.values()], k16["f12_mul"],
              on_path_range_launch=on_path["fp_mont_mul"],
              on_round={"launches": rnd["kernel_launches"]["fp_mont_mul"],
                        "widths": rnd["widths"]},
              on_service=on_service,
              on_sim={"launches": sim["b1_launches"],
                      "launches_in_round": sim["b1_launches_in_round"]},
              on_rlc=on_rlc("fp_mont_mul"),
              on_bls12_381=on_bls("fp_mont_mul", "cios", k24),
              on_adversarial_sim={"launches": adv["b1_launches"],
                                  "launches_in_round": adv["b1_launches_in_round"],
                                  "profiled_calls": adv["live"]["profiles"][-1]["b1_calls"]},
              on_rpc={"launches": rpc["kernel_launches"]["fp_mont_mul"],
                      "widths": rpc["widths"].get("fp_mont_mul", {})},
              on_ban_case={"launches": ban["kernel_launches"]["fp_mont_mul"],
                           "widths": ban["widths"].get("fp_mont_mul", {})},
              on_fleet={"device_host": {
                  "launches": fleet["remote"]["b1_launches"],
                  "launches_in_round": fleet["remote"]["b1_launches_in_round"],
                  "widths": fleet["remote"]["b1_widths"]},
                  "chipless_hosts": fleet["remote"]["chipless_b1_launches"],
                  "watch_launches_in_round": fleet["watch"]["b1_launches_in_round"]},
              on_lifecycle={"launches": life["kernel_launches"]["fp_mont_mul"],
                            "in_staging": [st["b1_calls"] for st in life["staging"]],
                            "staging_widths": [st["b1_widths"] for st in life["staging"]],
                            "in_flip": [f["b1_calls"] for f in life["flips"]]},
              on_weighted_sim={"launches": weighted["b1_launches"],
                               "launches_in_round": weighted["b1_launches_in_round"],
                               "by_process": weighted["b1_launches_in_round_by_process"]},
              on_mesh={"launches": mesh["kernel_launches"]["fp_mont_mul"],
                       "by_card": mesh["b1_by_card"],
                       "by_launch": {k: f["kernel_launches"].get("fp_mont_mul", 0)
                                     for k, f in mesh["launches"].items()},
                       "widths": mesh["widths"].get("fp_mont_mul", {})},
              on_stages=on_stages("cios")),
        entry("rns_mont_mul_resident", "handel_tpu_torch/csrc/rns_mont.cu",
              "handel_tpu/ops/rns.py:571", rns["rns_mont_mul_resident"],
              [*r46.values(), *r65.values()], r46["f12_mul"],
              on_path_range_launch=on_path["rns_mont_mul_resident"],
              on_service={"round_rns": {
                  "launches": srnd_rns["kernel_launches"]["rns_mont_mul_resident"],
                  "widths": srnd_rns["widths"].get("rns_mont_mul_resident", {})}},
              on_rlc=on_rlc("rns_mont_mul_resident"),
              on_bls12_381=on_bls("rns_mont_mul_resident", "rns", r65),
              on_stages=on_stages("rns")),
        *(entry(kname, "handel_tpu_torch/csrc/lab_mont.cu", "scripts/fp_kernel_lab.py:234",
                lab["executed"][kname], list(b3[kname].values()), b3[kname]["random+edges/16"],
                captured_calls=lab["captured"][kname], replayed_calls=lab["replayed"][kname],
                at_24_limbs={k: b3[kname]["random+edges/24"][k]
                             for k in ("ms", "plain_ms", "bound_ms", "ms_by_instance")},
                sass_per_column={k: v for k, v in (lab_sass or {}).items()
                                 if k.startswith(f"{kname}_kernel")})
          for kname in ("lab_cios_fullwidth", "lab_separated")),
    ]}))
    line("phases", seconds=clock.seconds, second_process_seconds=joined["seconds"])
    line("total", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
