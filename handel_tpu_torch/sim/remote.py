"""Multi-host simulation platform: ship, configure, start, collect — a copy
of handel_tpu/sim/remote.py.

Reference: simul/platform/aws.go:18-489 + simul/platform/aws/* — the
reference cross-compiles the node binary, ships binaries + configs (S3),
then SSH-configures and starts master and slaves across a fleet; nodes find
the master over DCN and the UDP sync barrier (simul/lib/sync.go:27-378)
coordinates the run. Terraform provisioning and the EC2 SDK are n/a here
(SURVEY.md §2.5); what this module keeps is the platform's JOB: given a
list of reachable hosts, deploy the package and run a distributed
simulation without any shared filesystem.

Host connectors:
  * ``local``  — this machine, via subprocesses. Deployment still goes
    through the tar ship path into a per-host staging dir, so CI exercises
    the exact multi-host flow with N "hosts" on localhost
    (localhost-as-remote; the reference tests its command builders the same
    way, simul/platform/aws/*_test.go).
  * ``ssh:<target>`` — a remote machine via ssh/OpenSSH. Shipping is
    `tar | ssh tar -x`; node processes stay attached to their ssh client so
    stdout/stderr stream back (the reference's exec-channel model,
    simul/platform/aws/sshController.go).

The orchestrator host runs the SyncMaster + Monitor in-process (the
reference's master binary role, simul/master/main.go) and writes the stats
CSV; remote nodes connect back over `master_ip`.

The package shipped is `handel_tpu_torch` with its CUDA sources (`csrc/`);
a host's node processes run `python -m handel_tpu_torch.sim.node` from its
staging dir, and a device host's process builds the kernels there, into
the staging dir's `build/torch_kernels/`, on first launch. With a device
scheme and `shared_verifier`, one process of the `device = true` host
serves its `BatchVerifierService` over TCP (`--serve-verifier`) and every
other process verifies through it (`--verifier`): those build their scheme
on the CPU and never touch the card (sim/node.py). The device is the one
$HANDEL_TORCH_DEVICE names (utils/torchenv.py), passed on to every node
process. As the localhost platform does, the orchestrator generates keys
on the host (no CUDA context) and keeps each node process's output as
`node_<run>_<host>_<process>.out` / `.err` in its workdir.

TOML:

    platform = "remote"          # or --platform remote on the CLI
    master_ip = "10.0.0.1"       # address nodes dial back to
    base_port = 21000            # node ports; 0 = probe (all-local only)
    [[hosts]]
    connect = "local"            # or "ssh:user@worker1"
    ip = "127.0.0.1"             # address other nodes dial this host's nodes
    python = "python3"
"""

from __future__ import annotations

import asyncio
import os
import re
import shlex
import sys
import tarfile
import tempfile

from handel_tpu_torch.models.registry import is_device_scheme, new_scheme
from handel_tpu_torch.sim import keys as simkeys
from handel_tpu_torch.sim.allocator import new_allocator
from handel_tpu_torch.sim.config import HostSpec, SimConfig, dump_config
from handel_tpu_torch.sim.monitor import Monitor
from handel_tpu_torch.sim.sync import STATE_END, STATE_START, SyncMaster


class HostConnector:
    """Transport to one host: ship files, run attached commands, kill."""

    def __init__(self, spec: HostSpec, staging: str):
        self.spec = spec
        self.staging = staging  # per-host working directory on the host

    async def ship(self, tar_path: str) -> None:
        raise NotImplementedError

    async def run(self, cmd: str) -> asyncio.subprocess.Process:
        raise NotImplementedError

    async def kill_pattern(self, pattern: str) -> None:
        raise NotImplementedError


class LocalConnector(HostConnector):
    """localhost-as-remote: same ship/run/kill contract via subprocesses."""

    async def ship(self, tar_path: str) -> None:
        await _check(
            await asyncio.create_subprocess_shell(
                f"mkdir -p {shlex.quote(self.staging)} && "
                f"tar -xzf {shlex.quote(tar_path)} -C {shlex.quote(self.staging)}"
            ),
            "local ship",
        )

    async def run(self, cmd: str) -> asyncio.subprocess.Process:
        # own session/process group: killing the wrapper shell alone would
        # orphan the python node process it spawned
        return await asyncio.create_subprocess_shell(
            f"cd {shlex.quote(self.staging)} && {cmd}",
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            start_new_session=True,
        )

    async def kill_pattern(self, pattern: str) -> None:
        p = await asyncio.create_subprocess_shell(
            f"pkill -f {shlex.quote(pattern)} 2>/dev/null; true"
        )
        await p.wait()


class SSHConnector(HostConnector):
    """OpenSSH transport (aws.go's sshController analog). BatchMode so a
    missing key fails fast instead of prompting."""

    SSH = "ssh -o BatchMode=yes -o StrictHostKeyChecking=accept-new"

    def __init__(self, spec: HostSpec, staging: str):
        super().__init__(spec, staging)
        self.target = spec.connect.split(":", 1)[1]

    def _remote(self, remote_cmd: str) -> str:
        """Local shell line running `remote_cmd` on the target: the remote
        command (already internally quoted) is quoted ONCE as a whole —
        hand-nesting quotes inside a single-quoted string breaks on any
        path that itself needs quoting."""
        q = shlex.quote
        return f"{self.SSH} {q(self.target)} {q(remote_cmd)}"

    async def ship(self, tar_path: str) -> None:
        q = shlex.quote
        remote = f"mkdir -p {q(self.staging)} && tar -xzf - -C {q(self.staging)}"
        await _check(
            await asyncio.create_subprocess_shell(
                f"cat {q(tar_path)} | {self._remote(remote)}"
            ),
            f"ssh ship to {self.target}",
        )

    async def run(self, cmd: str) -> asyncio.subprocess.Process:
        q = shlex.quote
        return await asyncio.create_subprocess_shell(
            self._remote(f"cd {q(self.staging)} && {cmd}"),
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )

    async def kill_pattern(self, pattern: str) -> None:
        q = shlex.quote
        p = await asyncio.create_subprocess_shell(
            self._remote(f"pkill -f {q(pattern)} 2>/dev/null; true")
        )
        await p.wait()


def _kill_all(procs) -> None:
    """Kill each launcher's whole process group (LocalConnector starts new
    sessions, so pgid == pid covers the shell AND the node python under it;
    ssh launchers have no local children — the remote side is handled by
    kill_pattern)."""
    import signal

    for p in procs:
        if p.returncode is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                p.kill()


async def _check(proc: asyncio.subprocess.Process, what: str) -> None:
    rc = await proc.wait()
    if rc != 0:
        raise RuntimeError(f"{what} failed (rc={rc})")


def _connector(spec: HostSpec, staging: str) -> HostConnector:
    if spec.connect == "local":
        return LocalConnector(spec, staging)
    if spec.connect.startswith("ssh:"):
        return SSHConnector(spec, staging)
    raise ValueError(f"unknown host connector {spec.connect!r}")


PACKAGE = "handel_tpu_torch"


def _pack_tree(workdir: str) -> str:
    """Tar the package source for shipping (the aws.go `pack` analog —
    Python ships source where Go shipped a cross-compiled binary): the
    port's package, its CUDA sources included, and nothing else of the
    repo."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tar_path = os.path.join(workdir, "handel_tpu_torch_pkg.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tf:
        tf.add(
            os.path.join(repo, PACKAGE),
            arcname=PACKAGE,
            filter=lambda ti: None if "__pycache__" in ti.name else ti,
        )
        pj = os.path.join(repo, "pyproject.toml")
        if os.path.exists(pj):
            tf.add(pj, arcname="pyproject.toml")
    return tar_path


class RemotePlatform:
    """Drive one simulation across the configured host list.

    Mirrors the aws platform lifecycle (platform.go:15-89 doc:
    configure -> build -> cleanup -> deploy -> start -> wait): `configure`
    packs + ships the package once; each `start_run` ships that run's
    registry/config, starts node processes on every host, runs the barrier,
    and writes the stats CSV locally.
    """

    def __init__(self, cfg: SimConfig, workdir: str):
        if not cfg.hosts:
            raise ValueError(
                "platform=remote needs at least one [[hosts]] entry"
            )
        self.cfg = cfg
        self.dir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.config_path = os.path.join(workdir, "sim.toml")
        with open(self.config_path, "w") as f:
            f.write(dump_config(cfg))
        # default staging dirs carry the orchestrator pid: two concurrent
        # runs with same-basename workdirs must not clobber each other's
        # shipped package/registry
        run_tag = (
            f"{os.path.basename(os.path.normpath(workdir)) or 'run'}"
            f"_{os.getpid()}"
        )
        self.connectors = [
            _connector(
                h,
                h.workdir
                or os.path.join(
                    tempfile.gettempdir(), f"handel_tpu_torch_remote_{run_tag}_{i}"
                ),
            )
            for i, h in enumerate(cfg.hosts)
        ]
        self._configured = False

    async def configure(self) -> None:
        """Pack once, ship to every host concurrently (aws.go:80-232)."""
        tar_path = _pack_tree(self.dir)
        await asyncio.gather(*(c.ship(tar_path) for c in self.connectors))
        self._configured = True

    async def _kill_everywhere(self, procs) -> None:
        """Kill the local client processes AND this run's remote nodes.
        Remote processes outlive their dead ssh client; the --tag (per-run
        staging dir, regex-escaped for pkill -f) scopes the kill to THIS
        run's nodes, not every simulation on a shared host."""
        _kill_all(procs)
        await asyncio.gather(
            *(
                c.kill_pattern(
                    f"{PACKAGE}[.]sim[.]node.*--tag {re.escape(c.staging)}"
                )
                for c in self.connectors
                if isinstance(c, SSHConnector)
            )
        )

    async def start_run(self, run_index: int):
        from handel_tpu_torch.sim.platform import (
            RunResult,
            free_ports,
            keep_node_outputs,
            port_plan,
        )

        if not self._configured:
            await self.configure()
        cfg = self.cfg
        run = cfg.runs[run_index]
        hosts = cfg.hosts
        # keygen is host work: the orchestrator's scheme holds no CUDA
        # context while the node processes run
        scheme = new_scheme(
            cfg.scheme,
            **({"device": "cpu", "warmup": False}
               if is_device_scheme(cfg.scheme) else {}),
        )

        # allocation: logical nodes round-robin over hosts ("instances"),
        # then over each host's processes (allocator.go:52-86)
        alloc = new_allocator(cfg.allocator).allocate(
            run.nodes, len(hosts), run.processes, run.failing
        )

        # addresses: every node advertised at its host's routable ip. With
        # base_port=0 (single-machine CI) ports are probed locally; a real
        # fleet sets base_port and the shared fixed plan applies
        # (platform.py port_plan: node i at base_port + i)
        if not cfg.base_port and any(h.connect != "local" for h in hosts):
            raise ValueError("base_port required with non-local hosts")
        ports, master_port, monitor_port, verifier_slot = port_plan(
            cfg, run.nodes
        )
        addresses = [
            f"{hosts[alloc[nid].instance].ip}:{ports[nid]}"
            for nid in range(run.nodes)
        ]

        # keygen -> registry CSV, shipped to every host (aws.go: S3 transfer)
        records = simkeys.generate_nodes(scheme, addresses)
        registry_name = f"registry_{run_index}.csv"
        registry_path = os.path.join(self.dir, registry_name)
        simkeys.write_registry_csv(registry_path, records)
        ship_tar = os.path.join(self.dir, f"run_{run_index}.tar.gz")
        with tarfile.open(ship_tar, "w:gz") as tf:
            tf.add(registry_path, arcname=registry_name)
            tf.add(self.config_path, arcname="sim.toml")
        await asyncio.gather(*(c.ship(ship_tar) for c in self.connectors))

        # batch-plane RPC (parallel/rpc_verifier.py): with a device-flagged
        # host and the shared verifier on a device scheme, exactly one
        # process on that host serves every other process's verification.
        # A fixed fleet uses the plan's base_port - 3 slot; otherwise the
        # port is probed on the orchestrator
        verifier_host_idx = next(
            (i for i, h in enumerate(hosts) if h.device), None
        )
        serve_verifier = (
            cfg.shared_verifier
            and is_device_scheme(cfg.scheme)
            and verifier_host_idx is not None
            and not cfg.baseline  # baseline runs never touch the verifier
        )
        verifier_port = (
            (verifier_slot or free_ports(1)[0]) if serve_verifier else 0
        )
        if serve_verifier and not any(
            alloc[nid].active and alloc[nid].instance == verifier_host_idx
            for nid in alloc
        ):
            raise ValueError(
                "device host has no active node process to serve the "
                "verifier from (all its nodes are failing)"
            )
        by_host_proc: dict[int, dict[int, list[int]]] = {}
        for nid, slot in alloc.items():
            if slot.active:
                by_host_proc.setdefault(slot.instance, {}).setdefault(
                    slot.process, []
                ).append(nid)
        active = sum(
            len(ids) for procs in by_host_proc.values() for ids in procs.values()
        )
        # both bind 0.0.0.0 (sim/sync.py, sim/monitor.py) so off-host nodes
        # can reach them at master_ip. Declared keys keep the CSV schema
        # stable when a degraded run records no samples (NaN + warning).
        monitor = Monitor(
            monitor_port,
            expected_keys=("sigen_wall", "sigs_sigCheckedCt", "net_sentPackets"),
        )
        await monitor.start()
        sync = SyncMaster(master_port, active)
        await sync.start()

        procs: list[asyncio.subprocess.Process] = []
        names: list[str] = []  # "<host>_<process>" of each launcher
        timed_out = False
        try:
            served = False
            for hidx, by_proc in sorted(by_host_proc.items()):
                conn = self.connectors[hidx]
                py = hosts[hidx].python or sys.executable
                for pidx, ids in sorted(by_proc.items()):
                    flags = (
                        f"--config sim.toml --registry {registry_name} "
                        f"--master {cfg.master_ip}:{master_port} "
                        f"--monitor {cfg.master_ip}:{monitor_port} "
                        f"--run {run_index} --ids {','.join(map(str, ids))} "
                        f"--tag {shlex.quote(conn.staging)}"
                    )
                    if cfg.trace:
                        # dumps land in the host's staging dir (node cwd);
                        # ssh hosts keep them host-side for manual fetch
                        flags += " --trace-dir ."
                    if serve_verifier:
                        if hidx == verifier_host_idx and not served:
                            flags += f" --serve-verifier {verifier_port}"
                            served = True
                        else:
                            flags += (
                                " --verifier "
                                f"{hosts[verifier_host_idx].ip}:{verifier_port}"
                            )
                    env = "PYTHONPATH=. "
                    if os.environ.get("HANDEL_TORCH_DEVICE"):
                        env += (
                            "HANDEL_TORCH_DEVICE="
                            f"{shlex.quote(os.environ['HANDEL_TORCH_DEVICE'])} "
                        )
                    procs.append(
                        await conn.run(
                            f"{env}{py} -m {PACKAGE}.sim.node {flags}"
                        )
                    )
                    names.append(f"{hidx}_{pidx}")
            try:
                await sync.wait_all(STATE_START, cfg.max_timeout_s)
                await sync.wait_all(STATE_END, cfg.max_timeout_s)
            except asyncio.TimeoutError:
                timed_out = True
                await self._kill_everywhere(procs)
            try:
                # grace period: a node can pass the END barrier yet fail to
                # exit (stuck device teardown) — don't hang the run forever
                outs = await asyncio.wait_for(
                    asyncio.gather(*(p.communicate() for p in procs)),
                    timeout=60.0,
                )
            except asyncio.TimeoutError:
                timed_out = True
                await self._kill_everywhere(procs)
                outs = [(b"", b"")] * len(procs)
            rcs = [p.returncode for p in procs]
        finally:
            _kill_all(procs)
            sync.stop()
            monitor.stop()

        keep_node_outputs(self.dir, run_index, names, outs)

        monitor.stats.extra = run.stats_extra(run_index)
        csv_path = os.path.join(self.dir, f"results_{run_index}.csv")
        monitor.stats.write_csv(csv_path)
        ok = (
            not timed_out
            and all(rc == 0 for rc in rcs)
            and all(b"finished OK" in out for out, _ in outs)
        )
        return RunResult(ok=ok, csv_path=csv_path, outputs=outs, returncodes=rcs)
