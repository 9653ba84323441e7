"""Simulation harness — the localhost run path of handel_tpu/sim/.

Reference: simul/ — orchestrator, TOML config matrix, platforms, node
binaries, UDP sync barrier, allocator, keygen and registry CSV, metrics
monitor.

`python -m handel_tpu_torch.sim --config c.toml --workdir out` runs each
`[[runs]]` entry on the localhost platform: real OS processes running
`python -m handel_tpu_torch.sim.node`, synchronized by a UDP barrier,
reporting to a UDP JSON monitor whose stats land in a CSV with the JAX
package's columns. One process can host many logical nodes sharing one
device batch verifier (parallel/batch_verifier.py), served to other
processes over TCP (parallel/rpc_verifier.py). Runs take `[chaos]`,
`[runs.adversaries]` (sim/adversary.py), span tracing (`trace = true`,
analyzed by `python -m handel_tpu_torch.sim trace <dir>`, sim/trace_cli.py)
and a /metrics endpoint per node process (`metrics = true`).
"""
