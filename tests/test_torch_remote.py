"""The port's multi-host pieces against the JAX package's: the remote
platform (handel_tpu_torch/sim/remote.py, `--platform remote`), the
standalone master (sim/master.py) and the transport demo
(network/examples.py).

The remote platform ships the port's package (and nothing of the JAX
package) into each host's staging dir and runs its nodes from there; on two
localhost-as-remote hosts its run writes the same CSV columns as the
reference's (exact column sets). With a device scheme and a host flagged
`device = true`, that host's process serves its shared verifier over TCP
and the other host's process verifies through it without touching a
device: the RPC counters are on the monitor plane, and the chip-less
process reports no CUDA context and no kernel launch. The standalone
master collects node processes' stats like the reference's, and the
demo's peers hear each other over UDP and TCP as the reference's do.
"""

import asyncio
import csv
import json
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest

from handel_tpu.sim import config as rconfig
from handel_tpu.sim.platform import run_simulation as r_run
from handel_tpu_torch.sim import config as pconfig
from handel_tpu_torch.sim import remote as premote
from handel_tpu_torch.sim.platform import new_platform
from handel_tpu_torch.sim.platform import run_simulation as p_run

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))


def kernel_line(path: Path) -> dict:
    """The `node process kernels:` JSON of a device-scheme node process."""
    (line,) = [ln for ln in path.read_text().splitlines()
               if ln.startswith("node process kernels: ")]
    return json.loads(line.split(": ", 1)[1])


def remote_cfg(mod, tmp_path, sub, scheme="fake", device=False, nodes=8, threshold=5, **kw):
    return mod.SimConfig(
        network="udp", scheme=scheme, max_timeout_s=kw.pop("max_timeout_s", 60.0),
        hosts=[mod.HostSpec(connect="local", workdir=str(tmp_path / sub / "hostA"), device=device),
               mod.HostSpec(connect="local", workdir=str(tmp_path / sub / "hostB"))],
        runs=[mod.RunConfig(nodes=nodes, threshold=threshold, processes=1,
                            handel=mod.HandelParams(period_ms=50.0, timeout_ms=200.0))],
        **kw,
    )


def run_remote(run, cfg, workdir):
    (res,) = asyncio.run(run(cfg, str(workdir), platform="remote"))
    if not res.ok:
        for out, err in res.outputs:
            print(out.decode(errors="replace"), err.decode(errors="replace"))
    return res


def test_pack_tree_ships_the_port_and_nothing_of_the_reference(tmp_path):
    tar_path = premote._pack_tree(str(tmp_path))
    with tarfile.open(tar_path) as tf:
        names = tf.getnames()
    tops = {n.split("/")[0] for n in names}
    assert tops == {"handel_tpu_torch", "pyproject.toml"}
    assert "handel_tpu_torch/sim/node.py" in names
    assert "handel_tpu_torch/csrc/fp_mont.cu" in names
    assert not any("__pycache__" in n for n in names)


def test_remote_platform_needs_hosts_and_names_the_platforms(tmp_path):
    cfg = pconfig.SimConfig(runs=[pconfig.RunConfig()])
    with pytest.raises(ValueError, match=r"\[\[hosts\]\]"):
        new_platform("remote", cfg, str(tmp_path))
    with pytest.raises(ValueError, match="unknown platform"):
        new_platform("aws", cfg, str(tmp_path))
    cfg.hosts = [pconfig.HostSpec(connect="telnet:h")]
    with pytest.raises(ValueError, match="unknown host connector"):
        new_platform("remote", cfg, str(tmp_path))


def test_remote_platform_stages_and_runs_a_mesh_config(tmp_path):
    """`mesh_devices = 2`, which the platform refused until the mesh was
    ported, passes its staging: both hosts get the config carrying the
    mesh width and the registry, and the run (the fake scheme, on which the
    width changes nothing, as in the reference) succeeds."""
    cfg = remote_cfg(pconfig, tmp_path, "port")
    cfg.mesh_devices = 2
    res = run_remote(p_run, cfg, tmp_path / "out")
    assert res.ok
    for host in ("hostA", "hostB"):
        staged = tmp_path / "port" / host
        assert "mesh_devices = 2" in (staged / "sim.toml").read_text()
        assert (staged / "registry_0.csv").exists()
        assert (staged / "handel_tpu_torch" / "parallel" / "sharding.py").exists()


def test_remote_platform_two_hosts_beside_reference(tmp_path):
    """Two localhost-as-remote hosts, the fake scheme: each host's node
    process runs from the shipped copy, and the CSV has the reference's
    columns."""
    res = run_remote(p_run, remote_cfg(pconfig, tmp_path, "port"), tmp_path / "port" / "out")
    ref = run_remote(r_run, remote_cfg(rconfig, tmp_path, "ref"), tmp_path / "ref" / "out")
    assert res.ok and ref.ok
    for host in ("hostA", "hostB"):
        staged = tmp_path / "port" / host
        assert (staged / "handel_tpu_torch" / "sim" / "node.py").exists()
        assert (staged / "registry_0.csv").exists() and not (staged / "handel_tpu").exists()
    assert len(res.outputs) == 2
    assert sorted(p.name for p in (tmp_path / "port" / "out").glob("node_0_*.out")) == \
        ["node_0_0_0.out", "node_0_1_1.out"]
    headers = [next(csv.reader(open(r.csv_path))) for r in (res, ref)]
    assert set(headers[0]) == set(headers[1])
    assert "sigen_wall_avg" in headers[0]


def rpc_checks(res):
    rows = list(csv.DictReader(open(res.csv_path)))
    # host B's process shipped candidates over the link; host A served them
    assert float(rows[0]["device_rpc_rpcSentCandidates_sum"]) > 0
    assert float(rows[0]["device_rpcserve_rpcServedCandidates_sum"]) > 0
    assert float(rows[0]["device_rpc_rpcLinkErrors_sum"]) == 0
    return set(rows[0])


def test_remote_platform_rpc_verifier_on_the_cpu_engine(tmp_path, monkeypatch):
    """The fleet of the north star on the CPU: host A (`device = true`)
    serves its shared verifier over the port's `bn254-cuda` engine, host
    B's process verifies every candidate through it. B builds no engine and
    holds no CUDA context; A's verifier launched."""
    monkeypatch.setenv("HANDEL_TORCH_DEVICE", "cpu")
    cfg = remote_cfg(pconfig, tmp_path, "port", scheme="bn254-cuda", device=True, nodes=4,
                     threshold=4, batch_size=4, shared_verifier=True, max_timeout_s=300.0)
    out = tmp_path / "port" / "out"
    res = run_remote(p_run, cfg, out)
    assert res.ok
    rpc_checks(res)
    served, chipless = kernel_line(out / "node_0_0_0.out"), kernel_line(out / "node_0_1_1.out")
    assert served["verifier_launches"] >= 1 and served["device"] == "cpu"
    assert chipless["verifier_launches"] is None and chipless["device"] == "None"
    assert not chipless["initialized_cuda"] and not served["initialized_cuda"]
    assert chipless["launches"] == {"fp_mont_mul": 0, "rns_mont_mul_resident": 0}


@pytest.mark.slow
def test_remote_platform_rpc_verifier_beside_reference(tmp_path, monkeypatch):
    """The same fleet through both packages (the reference's device scheme
    on JAX's CPU backend, minutes of XLA): the same CSV columns, the RPC
    counters in both."""
    monkeypatch.setenv("HANDEL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("HANDEL_TPU_PLATFORM", "cpu")
    kw = dict(scheme="bn254-jax", device=True, batch_size=8, shared_verifier=True,
              max_timeout_s=900.0)
    res = run_remote(p_run, remote_cfg(pconfig, tmp_path, "port", **kw), tmp_path / "port" / "out")
    ref = run_remote(r_run, remote_cfg(rconfig, tmp_path, "ref", **kw), tmp_path / "ref" / "out")
    assert res.ok and ref.ok
    assert rpc_checks(res) == rpc_checks(ref)


def master_and_node(pkg: str, tmp_path: Path) -> tuple[str, set]:
    """A standalone master process and one node process of `pkg` (4 nodes,
    the fake scheme): the master's output and the CSV header it wrote."""
    keys = __import__(f"{pkg}.sim.keys", fromlist=["x"])
    config = __import__(f"{pkg}.sim.config", fromlist=["x"])
    registry = __import__(f"{pkg}.models.registry", fromlist=["x"])
    from handel_tpu_torch.sim.platform import free_ports

    n = 4
    ports = free_ports(n + 2)
    reg_path, cfg_path, csv_path = (str(tmp_path / f"{pkg}.{x}") for x in ("csv", "toml", "stats.csv"))
    keys.write_registry_csv(reg_path, keys.generate_nodes(
        registry.new_scheme("fake"), [f"127.0.0.1:{p}" for p in ports[:n]]))
    Path(cfg_path).write_text(config.dump_config(
        config.SimConfig(network="udp", scheme="fake", runs=[config.RunConfig(nodes=n)])))

    async def go():
        master = await asyncio.create_subprocess_exec(
            sys.executable, "-m", f"{pkg}.sim.master", "--port", str(ports[n]),
            "--monitor-port", str(ports[n + 1]), "--expected", str(n), "--csv", csv_path,
            "--timeout", "60", "--extra", f"nodes={n}", "--filter", "sigen_wall=99",
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE, env=ENV, cwd=ROOT)
        node = await asyncio.create_subprocess_exec(
            sys.executable, "-m", f"{pkg}.sim.node", "--config", cfg_path, "--registry", reg_path,
            "--master", f"127.0.0.1:{ports[n]}", "--monitor", f"127.0.0.1:{ports[n + 1]}",
            "--run", "0", "--ids", ",".join(map(str, range(n))),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE, env=ENV, cwd=ROOT)
        (m_out, m_err), (_, n_err) = await asyncio.wait_for(
            asyncio.gather(master.communicate(), node.communicate()), 90)
        assert master.returncode == 0, m_err.decode()
        assert node.returncode == 0, n_err.decode()
        return m_out.decode()

    out = asyncio.run(go())
    with open(csv_path) as f:
        return out, set(next(csv.reader(f)))


def test_standalone_master_with_node_processes_beside_reference(tmp_path):
    out, header = master_and_node("handel_tpu_torch", tmp_path)
    r_out, r_header = master_and_node("handel_tpu", tmp_path)
    assert header == r_header and "nodes" in header and "sigen_wall_avg" in header
    strip = lambda s: [ln.split(" on :")[0].split(" -> ")[0] for ln in s.splitlines()]  # noqa: E731
    assert strip(out) == strip(r_out)
    assert "master: END released" in out


@pytest.mark.parametrize("kind", ["udp", "tcp"])
def test_transport_demo_peers_hear_each_other_alike(kind):
    from handel_tpu.network.examples import run_demo as r_demo
    from handel_tpu_torch.network.examples import run_demo as p_demo

    for n in (2, 4):
        want = {i: set(range(n)) - {i} for i in range(n)}
        assert asyncio.run(p_demo(n, kind)) == asyncio.run(r_demo(n, kind)) == want
    with pytest.raises(ValueError, match="unknown transport"):
        asyncio.run(p_demo(2, "quic"))


def test_transport_demo_cli_prints_the_reference_lines():
    outs = [
        subprocess.run([sys.executable, "-m", f"{pkg}.network.examples", "3", "tcp"],
                       cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=60)
        for pkg in ("handel_tpu_torch", "handel_tpu")
    ]
    assert [o.returncode for o in outs] == [0, 0], outs[0].stderr
    assert outs[0].stdout == outs[1].stdout == (
        "peer 0: heard from [1, 2]\npeer 1: heard from [0, 2]\npeer 2: heard from [0, 1]\n")
