"""The port's kernel labs (handel_tpu_torch/scripts/) against the reference's.

The reference's scripts/fp_kernel_lab.py and scripts/mxu_limb_lab.py are
loaded by path (nothing in them changes) and run on the CPU: the two lab
bodies under jax.jit with pad=False and pad=True (the pad=True body is what
their Pallas kernel runs), and make_outer8_mont under jax.jit. The same
seeded inputs go through the port's plain bodies; the tolerance is exact
(integer arithmetic). Also here: the lab's validation and failure exit on
the CPU, and the contract of `chained_marginal` on CPU tensors.
"""

import functools
import importlib.util
import json
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handel_tpu.ops import bls12_381_ref
from handel_tpu.ops.fp import Field as JaxField
from handel_tpu_torch.ops import bn254_ref as bn
from handel_tpu_torch.ops import fp as port_fp
from handel_tpu_torch.ops.fp import Field, chain, chained_marginal
from handel_tpu_torch.scripts import fp_kernel_lab, mxu_limb_lab
from handel_tpu_torch.scripts.fp_kernel_lab import LabField

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PRIMES = {"bn254": bn.P, "bls12_381": bls12_381_ref.P}
COLS = 96


def load_reference(name: str):
    """scripts/<name>.py of the JAX package, imported by path."""
    mod_name = f"reference_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=sorted(PRIMES))
def labs(request):
    p = PRIMES[request.param]
    ref = load_reference("fp_kernel_lab")
    return LabField(Field(p, device="cpu")), ref.LabField(JaxField(p, use_pallas=False))


def operands(F: Field, kind: str):
    """(a, b) int32 tensors: canonical columns led by every pair of the edge
    values 0, 1, p-1, R mod p, p-2, or raw 16-bit digits (values up to R-1)."""
    p = F.p
    if kind == "canonical":
        rng = random.Random(p % 997)
        edges = [0, 1, p - 1, F.mont_r, p - 2]
        xs = [x for x in edges for _ in edges] + [rng.randrange(p) for _ in range(COLS)]
        ys = [y for _ in edges for y in edges] + [rng.randrange(p) for _ in range(COLS)]
        return F.pack(xs, mont=False), F.pack(ys, mont=False)
    rng = np.random.default_rng(p % 991)
    a = rng.integers(0, 1 << 16, (F.nlimbs, COLS + 25)).astype(np.int32)
    b = rng.integers(0, 1 << 16, (F.nlimbs, COLS + 25)).astype(np.int32)
    a[:, 0] = b[:, 0] = b[:, 1] = 0xFFFF
    return torch.from_numpy(a), torch.from_numpy(b)


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def from_jax(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def test_constants_match_reference(labs):
    lab, ref = labs
    assert lab.n == ref.n and lab.n0 == ref.n0 and lab.pprime == ref.pprime
    assert lab.pprime_limbs == ref.pprime_limbs and lab.p_limbs == ref.p_limbs


@pytest.mark.parametrize("kind", ["canonical", "raw"])
@pytest.mark.parametrize("form", ["cios_fullwidth", "separated"])
def test_plain_bodies_match_reference_bodies(labs, form, kind):
    lab, ref = labs
    a, b = operands(lab.F, kind)
    ja, jb = to_jax(a), to_jax(b)
    ref_body = {"cios_fullwidth": ref.cios_fullwidth_body, "separated": ref.separated_body}[form]
    ours = lab.body(form)(a, b)
    for pad in (False, True):
        want = from_jax(jax.jit(functools.partial(ref_body, pad=pad))(ja, jb))
        assert torch.equal(ours, want), (form, kind, pad)
    # and the production field's plain product, on both kinds of input
    assert torch.equal(want, lab.F._mul_plain(a, b))
    if kind == "canonical":
        rinv = pow(lab.F.mont_r, -1, lab.p)
        xs, ys = lab.F.unpack(a, mont=False), lab.F.unpack(b, mont=False)
        assert lab.F.unpack(want, mont=False) == [x * y * rinv % lab.p for x, y in zip(xs, ys)]


def test_kernel_methods_take_the_plain_body_on_the_cpu():
    from handel_tpu_torch.kernels.lab_mont import lab_cios_fullwidth, lab_separated

    lab = LabField(Field(bn.P, device="cpu"))
    a, b = operands(lab.F, "canonical")
    before = (lab_cios_fullwidth.launches, lab_separated.launches)
    for form in ("cios_fullwidth", "separated"):
        for threads in (64, 512):
            assert torch.equal(lab.kernel(form, threads)(a, b), lab.body(form)(a, b))
    assert (lab_cios_fullwidth.launches, lab_separated.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        lab_cios_fullwidth(lab, a, b)
    with pytest.raises(ValueError, match="threads"):
        lab_separated(lab, a, b, threads=96)


def test_validate_passes_every_cpu_candidate():
    F = Field(bn.P, device="cpu")
    lab = LabField(F)
    cands = fp_kernel_lab.candidates(F, lab, Field(bn.P, backend="rns", device="cpu"))
    assert [nm for nm, _, _ in cands] == [
        "prod(Field.mul)", "rns(Field backend)", "plain:cios_fullwidth", "plain:separated",
    ]
    for _nm, fn, cf in cands:
        fp_kernel_lab.validate(cf, fn)
    with pytest.raises(AssertionError, match="mismatch at lanes"):
        fp_kernel_lab.validate(F, lambda a, b: F.mul(a, b) ^ 1)


def test_lab_main_on_the_cpu(capsys):
    out = fp_kernel_lab.main(["256", "--device", "cpu"])
    assert out["device"] == "cpu" and out["failed"] == []
    assert set(out["muls_per_s"]) == {
        "prod(Field.mul)", "rns(Field backend)", "plain:cios_fullwidth", "plain:separated",
    }
    # the CPU chains run eagerly: nothing captured, nothing replayed
    assert out["captured_calls"] == out["replayed_calls"] == dict.fromkeys(out["muls_per_s"], 0)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("{") and '"fp_kernel_lab"' in last


def test_raw_operands_are_the_reference_race_inputs():
    F = Field(bn.P, device="cpu")
    a, b = fp_kernel_lab.raw_operands(F, 300)
    rng = np.random.default_rng(3)
    for got in (a, b):
        want = rng.integers(0, 1 << 16, (F.nlimbs, 300), np.uint32)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy().astype(np.uint32), want)


def test_lab_main_exits_nonzero_on_a_failed_candidate(monkeypatch, capsys):
    body = LabField.separated_body

    def corrupt(self, a, b):
        out = body(self, a, b)
        out[0, 3] ^= 1
        return out

    monkeypatch.setattr(LabField, "separated_body", corrupt)
    with pytest.raises(SystemExit) as exc:
        fp_kernel_lab.main(["256", "--device", "cpu"])
    assert exc.value.code not in (0, None)
    shown = capsys.readouterr().out
    assert "plain:separated              validate: FAIL" in shown
    assert '"failed": ["plain:separated"]' in shown


def test_outer8_mont_matches_reference():
    ref = load_reference("mxu_limb_lab")
    F = Field(bn.P, device="cpu")
    J = JaxField(bn.P, use_pallas=False)
    rng = np.random.default_rng(11)
    vals = [int.from_bytes(bytes(r), "little") % F.p
            for r in rng.integers(0, 256, (2 * 256, 32), np.uint8)]
    a, b = F.pack(vals[:256], mont=False), F.pack(vals[256:], mont=False)
    a[:, 0], b[:, 1] = F.pack([F.p - 1], mont=False)[:, 0], F.pack([F.p - 1], mont=False)[:, 0]
    ours = mxu_limb_lab.make_outer8_mont(F)(a, b)
    assert torch.equal(ours, from_jax(jax.jit(ref.make_outer8_mont(J))(to_jax(a), to_jax(b))))
    assert torch.equal(ours, F.mul(a, b))
    assert torch.equal(mxu_limb_lab.split8(a), from_jax(ref.split8(to_jax(a))))


def test_mxu_lab_main_on_the_cpu(capsys):
    out = mxu_limb_lab.main(["256", "--device", "cpu", "--int8-n", "64"])
    assert out["device"] == "cpu" and out["batch"] == 256
    assert out["int8_ops_per_s"] > 0 and out["int8_ops_per_s_row_major_b"] > 0
    assert out["int8_share_of_datasheet"] is None  # a CPU figure is no share of the card
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"lab": "mxu_limb_lab"')


# -- chained_marginal on CPU tensors -------------------------------------------


def test_chain_is_k_applications():
    F = Field(bn.P, device="cpu")
    a, b = F.pack([3, 5, 7]), F.pack([11, 13, 2])
    want = a
    for _ in range(4):
        want = F.mul(want, b)
    assert torch.equal(chain(F.mul, a, b, 4), want)
    assert torch.equal(chain(F.mul, a, b, 0), a)


@pytest.mark.parametrize("backend", ["cios", "rns"])
def test_throughput_bench_on_cpu_tensors(capsys, backend):
    rate, floor = port_fp._throughput_bench(128, trials=1, backend=backend, device="cpu")
    assert rate >= 0.0 and floor >= 0.0
    shown = capsys.readouterr().out
    assert shown.startswith("cpu: ")
    assert f"[{backend}]" in shown or "not measurable" in shown


def test_chained_marginal_contract_on_cpu_tensors():
    F = Field(bn.P, device="cpu")
    a = F.pack(list(range(1, 65)))
    rate, floor = chained_marginal(F.mul, a, a, k1=2, k2=12, trials=2)
    assert floor >= 0.0
    assert rate is None or rate > 0.0


@pytest.mark.parametrize("times, want_rate", [
    ({2: 0.5, 10: 0.9}, 8 * 64 / 0.4),  # the slope
    ({2: 0.5, 10: 0.5}, None),  # no slope, also after the retry
])
def test_chained_marginal_slope(monkeypatch, times, want_rate):
    calls = []

    def fake_best(fn, a, b, k, trials, tally):
        calls.append(k)
        return times[k]

    monkeypatch.setattr(port_fp, "_best_chain_s", fake_best)
    a = torch.zeros((16, 64), dtype=torch.int32)
    rate, floor = chained_marginal(None, a, a, k1=2, k2=10)
    if want_rate is None:
        assert rate is None and floor == 0.5 and calls == [2, 10, 2, 10]
    else:
        assert rate == pytest.approx(want_rate) and calls == [2, 10]
        assert floor == pytest.approx(0.5 - 2 * 64 / want_rate)


def _lab_out(batch, rate=1.5e6):
    return {"lab": "mxu_limb_lab", "device": "cpu", "batch": batch,
            "prod_muls_per_s": rate, "outer8_muls_per_s": 2.0e5, "rns_muls_per_s": 3.0e5}


def test_mxu_persist_refuses_the_default_file_off_the_card_and_for_small_batches(
        tmp_path, monkeypatch, capsys):
    """--persist's refusals, as the reference's: no CPU run and no batch
    under 32,768 writes the default file (pointed here at tmp_path)."""
    default = tmp_path / "fp_microbench.json"
    monkeypatch.setattr(mxu_limb_lab, "FP_ARTIFACT", str(default))
    monkeypatch.delenv(mxu_limb_lab.FP_ARTIFACT_ENV, raising=False)
    assert mxu_limb_lab.persist(_lab_out(1 << 16), torch.device("cpu")) is None
    assert "refusing --persist on cpu" in capsys.readouterr().out
    # a card's run of a small batch (refused before nvidia-smi is asked)
    assert mxu_limb_lab.persist(_lab_out(256), torch.device("cuda")) is None
    assert "refusing --persist at batch 256" in capsys.readouterr().out
    assert not default.exists()


def test_mxu_persist_writes_through_the_override(tmp_path, monkeypatch, capsys):
    """The override variable takes any run: the "mxu_lab" entry is written
    atomically beside the file's other entries, a corrupt file is
    replaced, and a lost slope keeps the prior figure with a note."""
    path = tmp_path / "fp.json"
    monkeypatch.setenv(mxu_limb_lab.FP_ARTIFACT_ENV, str(path))
    path.write_text('{"mxu_lab": {"batch": 1')  # cut short by a killed writer
    assert mxu_limb_lab.persist(_lab_out(256), torch.device("cpu")) == str(path)
    art = json.loads(path.read_text())
    assert art["mxu_lab"]["prod_muls_per_s"] == 1.5e6 and art["mxu_lab"]["nvidia_smi"] is None
    art["other"] = {"kept": True}
    path.write_text(json.dumps(art))
    mxu_limb_lab.persist(_lab_out(512, rate=None), torch.device("cpu"))
    art = json.loads(path.read_text())
    assert art["other"] == {"kept": True}
    assert art["mxu_lab"]["batch"] == 512 and art["mxu_lab"]["prod_muls_per_s"] == 1.5e6
    assert "carried from the prior capture (batch 256" in art["mxu_lab"]["prod_note"]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp_")]
    # the flag reaches it from main
    out = mxu_limb_lab.main(["256", "--device", "cpu", "--int8-n", "64", "--persist"])
    assert json.loads(path.read_text())["mxu_lab"]["batch"] == out["batch"] == 256
    assert f"persisted mxu_lab -> {path}" in capsys.readouterr().out
