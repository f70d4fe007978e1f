"""Port of tests/test_microbench.py to tpu_operator_torch, plus kernel parity.

Everything runs on ``device="cpu"``, where each kernel wrapper takes its
plain PyTorch version; the parity tests feed the same numpy inputs to the
JAX package's Pallas kernels (interpret mode, as tests/test_microbench.py
runs them) and to the port's wrappers.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_operator.validator import microbench as jmb
from tpu_operator_torch.validator import microbench as mb
from tpu_operator_torch.validator import ops

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs in several worker processes at once; torch's default
    of one intra-op thread per core in each would take the cores from the
    timing-sensitive tests running beside these (tests/test_profile.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bf16_pair(x: np.ndarray):
    """The same bf16 values as a torch tensor and a JAX array."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


# --------------------------------------------------------------------------
# kernel parity against the JAX package's Pallas kernels
# --------------------------------------------------------------------------

# (JAX kt, port kt, block, m, k, n): the 256^2 cases of both TPU kernels,
# each (block, K-step) instantiation of the port's kernel at its smallest
# shape (m = n = block, k = two K-steps), reached through both kt routes, and
# the burn-in's 512^2
@pytest.mark.parametrize("jax_kt,port_kt,block,m,k,n", [
    pytest.param(0, 0, 128, 256, 256, 256, id="0-0"),
    pytest.param(128, 64, 128, 256, 256, 256, id="128-64"),
    pytest.param(0, 0, 64, 64, 64, 64, id="block64-kstep32"),
    pytest.param(64, 64, 64, 64, 128, 64, id="block64-kstep64"),
    pytest.param(32, 32, 128, 128, 64, 128, id="block128-kstep32"),
    pytest.param(0, 64, 128, 128, 128, 128, id="block128-kstep64"),
    pytest.param(0, 0, 128, 512, 512, 512, id="512"),
])
def test_matmul_matches_pallas(jax_kt, port_kt, block, m, k, n):
    # tolerance: summation order only (max seen 1.9e-5 at 256^3)
    rng = np.random.default_rng(1)
    a_t, a_j = _bf16_pair(rng.standard_normal((m, k), dtype=np.float32))
    b_t, b_j = _bf16_pair(rng.standard_normal((k, n), dtype=np.float32))
    want = np.asarray(jmb._pallas_matmul(a_j, b_j, block, True, jax_kt))
    got = ops.matmul_bf16_f32(a_t, b_t, kt=port_kt, block=block).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("scale", [3.0, 0.25])
def test_triad_matches_pallas_in_place(scale):
    # tolerance: XLA contracts a*scale+b to one FMA, the plain version
    # rounds twice (max seen 9.5e-7)
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 2048), dtype=np.float32)
    b = rng.standard_normal((16, 2048), dtype=np.float32)
    want = np.asarray(jmb._pallas_triad(jnp.asarray(a), jnp.asarray(b), 8,
                                        scale, True))
    ta = torch.from_numpy(a.copy())
    out = ops.triad_(ta, torch.from_numpy(b), scale)
    assert out.data_ptr() == ta.data_ptr()       # written in place
    np.testing.assert_allclose(ta.numpy(), want, atol=2e-6, rtol=0)


def test_fma_relu_matches_pallas():
    # tolerance: rounding of a*b+c (max seen 4.8e-7)
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal((64, 128), dtype=np.float32)
               for _ in range(3))
    want = np.asarray(pl.pallas_call(
        jmb._fma_kernel,
        out_shape=jax.ShapeDtypeStruct((64, 128), jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    got = ops.fma_relu(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got >= 0).all()


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launches()
    mb.run_microbench(quick=True, device=CPU)
    assert set(ops.LAUNCHES.values()) == {0}


# --------------------------------------------------------------------------
# counterparts of tests/test_microbench.py
# --------------------------------------------------------------------------

def test_vpu_probe_correct():
    r = mb.vpu_probe(rows=64, cols=128, device=CPU)
    assert r.ok, r.detail


def test_mxu_probe_matches_plain():
    r = mb.mxu_probe(enforce=True, device=CPU)  # no floor on the CPU
    assert r.ok, r.detail
    assert r.value is not None and np.isfinite(r.value)


def test_hbm_probe_correct():
    r = mb.hbm_probe(enforce=True, device=CPU)
    assert r.ok, r.detail
    assert r.value is not None and np.isfinite(r.value)


def test_mxu_probe_kblocked_matches_plain():
    """kt > 0 is the k-blocked kernel's route (K-step = kt)."""
    r = mb.mxu_probe(kt=64, device=CPU)
    assert r.ok, r.detail
    assert "kt 64" in r.detail


def test_mxu_probe_defaults_come_from_tiling_table():
    assert mb.MXU_TILING[""] == (2048, 128, 0)
    r = mb.mxu_probe(device=CPU)
    assert r.ok, r.detail
    assert "block 128" in r.detail


def test_mxu_sweep_reports_grid_winner_and_failures():
    out = mb.mxu_sweep(points=((256, 128, 0), (256, 128, 64), (256, 128, 48)),
                       reps=1, device=CPU)
    assert out["best"] is not None
    scored = [r for r in out["results"] if "tflops" in r]
    assert out["best"] == max(scored, key=lambda r: r["tflops"])
    # kt 48 is no K-step of the kernel: reported as a failed point
    assert "error" in out["results"][-1]
    assert mb.mxu_sweep(deadline_s=-1.0, device=CPU)["truncated"] is True


def test_hbm_sweep_reports_grid_and_winner():
    out = mb.hbm_sweep(mibs=(1,), threads=(128, 256), reps=1, device=CPU)
    assert out["results"], out
    assert out["best"] == max(out["results"], key=lambda r: r["gibs"])
    for point in out["results"]:
        assert {"mib", "threads", "gibs"} <= set(point)


def test_hbm_sweep_fails_a_point_with_a_wrong_result(monkeypatch):
    """A probe that measured a rate but read back a wrong result is a
    failed point, not a measured one."""
    wrong = mb.ValidationReport("hbm-probe", False, 0.1,
                                "2800.0 GiB/s triad, WRONG RESULT",
                                value=2800.0)
    monkeypatch.setattr(mb, "hbm_probe", lambda **kw: wrong)
    out = mb.hbm_sweep(mibs=(1,), threads=(256,), reps=1, device=CPU)
    assert out["best"] is None
    assert all("gibs" not in r and "WRONG" in r["error"]
               for r in out["results"])


def test_hbm_sweep_respects_deadline_and_marks_truncation():
    out = mb.hbm_sweep(deadline_s=-1.0, device=CPU)
    assert out["results"] == [] and out["best"] is None
    assert out["truncated"] is True
    assert out["interpret"] is True      # CPU: plain versions, not evidence


def test_hbm_probe_defaults_come_from_tiling_table():
    assert mb.HBM_TILING[""] == (256, 256)
    r = mb.hbm_probe(device=CPU)
    assert r.ok, r.detail
    assert "256 threads/block" in r.detail


def test_run_microbench_quick():
    reports = mb.run_microbench(quick=True, device=CPU)
    names = [r.name for r in reports]
    assert names == ["vpu-probe", "mxu-probe", "hbm-probe"]
    assert all(r.ok for r in reports), [(r.name, r.detail) for r in reports]


@pytest.mark.parametrize("name,gen", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 SXM5 80GB", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", ""),
    ("NVIDIA A100-SXM4-80GB", ""),
    ("weird device", ""),
])
def test_chip_gen_mapping(name, gen):
    assert mb._chip_gen(name) == gen


def test_chip_peaks_cover_known_gens():
    for gen in ("h100-sxm", "h100-pcie"):
        tflops, gbs = mb.CHIP_PEAKS[gen]
        assert tflops > 0 and gbs > 0
    assert mb.chip_generation(CPU) == ""


# the worst probe readings recorded on an H100 80GB HBM3 at 700 W
# (PERF.md §2), in TFLOP/s and GiB/s
WORST_RECORDED = {"mxu": 228.95, "hbm": 2838.5}
# on the CPU both probes clamp their shapes (256^2, 1 MiB): the work per
# step of the rate they time tells the two apart
MXU_CPU_WORK = 2.0 * 256 ** 3


def _stub_rates(monkeypatch, module, tflops: float, gibs: float) -> None:
    """Both probes of ``module`` read ``tflops`` and ``gibs``: the timed
    chains are replaced by their readings."""
    def rate(run, work_per_rep, r1, r2):
        if work_per_rep == MXU_CPU_WORK:
            return tflops * 1e12
        return gibs * 1024 ** 3
    monkeypatch.setattr(module, "_two_point_rate", rate)


def _perf_component(tmp_path, monkeypatch, enforce: bool):
    """run_component("perf") on the CPU: (values or the error, the
    perf-report file, whether perf-ready was written)."""
    from tpu_operator_torch import statusfiles
    from tpu_operator_torch.validator.components import (Context,
                                                         ValidationError,
                                                         run_component)
    monkeypatch.setenv("PERF_ENFORCE", "true" if enforce else "false")
    monkeypatch.delenv("PERF_QUICK", raising=False)
    status = str(tmp_path / "status")
    ctx = Context(status_dir=status, device=CPU)
    try:
        out = run_component("perf", ctx)
    except ValidationError as e:
        out = e
    return (out, statusfiles.read_status("perf-report", status),
            os.path.exists(os.path.join(status, "perf-ready")))


@pytest.mark.parametrize("share,enforce,passes", [
    pytest.param(0.5, True, False, id="half-the-worst-fails"),
    pytest.param(1.0, True, True, id="the-worst-passes"),
    pytest.param(0.5, False, True, id="not-enforced-passes"),
])
def test_perf_gate_on_an_h100(tmp_path, monkeypatch, share, enforce, passes):
    """An H100 SXM is gated on both floors: a card reading half the worst
    recorded rate fails both probes and gets no perf-ready, while the
    worst recorded rate passes; PERF_ENFORCE=false reports the floors and
    gates nothing."""
    monkeypatch.setattr(mb, "chip_generation", lambda device: "h100-sxm")
    _stub_rates(monkeypatch, mb, share * WORST_RECORDED["mxu"],
                share * WORST_RECORDED["hbm"])
    mxu = mb.mxu_probe(enforce=enforce, device=CPU)
    hbm = mb.hbm_probe(enforce=enforce, device=CPU)
    assert (mxu.ok, hbm.ok) == (passes, passes), (mxu.detail, hbm.detail)
    out, report, ready = _perf_component(tmp_path, monkeypatch, enforce)
    assert ready is passes
    assert {"mxu_tflops_floor", "hbm_gibs_floor"} <= set(report)
    assert report["enforced"] == ("true" if enforce else "false")
    assert report["mxu-probe_ok"] == report["hbm-probe_ok"] == (
        "true" if passes else "false")
    if passes:
        assert out["chip_gen"] == "h100-sxm"
    else:
        assert "mxu-probe" in str(out) and "hbm-probe" in str(out)

    floors = (mb.CHIP_PEAKS["h100-sxm"][0] * mb.MXU_GATE_FRACTION,
              mb.CHIP_PEAKS["h100-sxm"][1] * mb.HBM_GATE_FRACTION
              / 1.073741824)
    assert (mxu.floor, hbm.floor) == pytest.approx(floors)
    assert f"floor {floors[0]:.0f} [h100-sxm]" in mxu.detail
    assert f"floor {floors[1]:.0f} [h100-sxm]" in hbm.detail
    assert report["mxu_tflops_floor"] == f"{floors[0]:.1f}"
    assert report["hbm_gibs_floor"] == f"{floors[1]:.1f}"


def test_every_part_has_both_floors():
    """As the reference gates every generation it knows, every part of
    CHIP_PEAKS gets both floors, the same fractions of its peaks."""
    assert 0.0 < mb.MXU_GATE_FRACTION < mb.HBM_GATE_FRACTION < 1.0
    for gen in mb.CHIP_PEAKS:
        tflops, gbs = mb.CHIP_PEAKS[gen]
        assert tflops * mb.MXU_GATE_FRACTION > 0
        assert gbs * mb.HBM_GATE_FRACTION > 0
    # the worst recorded readings clear their floors; half of them do not
    tflops, gbs = mb.CHIP_PEAKS["h100-sxm"]
    hbm_floor = gbs * mb.HBM_GATE_FRACTION / 1.073741824
    mxu_floor = tflops * mb.MXU_GATE_FRACTION
    assert WORST_RECORDED["hbm"] / 2 < hbm_floor < WORST_RECORDED["hbm"]
    assert WORST_RECORDED["mxu"] / 2 < mxu_floor < WORST_RECORDED["mxu"]


# each fraction of both floors, on a generation each package knows
@pytest.mark.parametrize("fraction", [0.5, 0.99, 1.01, 2.0])
def test_perf_gate_matches_jax(tmp_path, monkeypatch, fraction):
    """The JAX package's validate_perf (Pallas in interpret mode, v5e
    forced) and the port's (h100-sxm forced), each reading the same
    fraction of its own floors, fail or pass alike and report the same
    keys."""
    from tpu_operator import statusfiles as jax_statusfiles
    from tpu_operator.host import make_fake_host as jax_fake_host
    from tpu_operator.validator import components as jax_components

    monkeypatch.setattr(jmb, "_on_tpu", lambda: True)
    monkeypatch.setattr(jmb, "_interpret", lambda: True)
    monkeypatch.setattr(jmb, "_chip_gen", lambda device=None: "v5e")
    tflops, gbs = jmb.CHIP_PEAKS["v5e"]
    _stub_rates(monkeypatch, jmb, fraction * tflops * jmb.MXU_GATE_FRACTION,
                fraction * gbs * jmb.HBM_GATE_FRACTION / 1.073741824)
    monkeypatch.setenv("PERF_ENFORCE", "true")
    monkeypatch.delenv("PERF_QUICK", raising=False)
    jax_status = str(tmp_path / "jax")
    ctx = jax_components.Context(host=jax_fake_host(str(tmp_path / "host")),
                                 status_dir=jax_status)
    try:
        jax_components.run_component("perf", ctx)
        jax_passed = True
    except jax_components.ValidationError:
        jax_passed = False
    jax_report = jax_statusfiles.read_status("perf-report", jax_status)

    monkeypatch.setattr(mb, "chip_generation", lambda device: "h100-sxm")
    tflops, gbs = mb.CHIP_PEAKS["h100-sxm"]
    _stub_rates(monkeypatch, mb, fraction * tflops * mb.MXU_GATE_FRACTION,
                fraction * gbs * mb.HBM_GATE_FRACTION / 1.073741824)
    out, report, ready = _perf_component(tmp_path / "port", monkeypatch, True)

    assert jax_passed is (fraction > 1.0)
    assert ready is jax_passed
    assert os.path.exists(os.path.join(jax_status, "perf-ready")) is ready
    assert sorted(report) == sorted(jax_report)
    for key in ("mxu-probe_ok", "hbm-probe_ok", "vpu-probe_ok", "enforced"):
        assert report[key] == jax_report[key], key


def test_perf_component_registered(tmp_path, monkeypatch):
    from tpu_operator_torch.validator.components import (COMPONENTS,
                                                         STATUS_FILES,
                                                         Context,
                                                         run_component)
    assert "perf" in COMPONENTS and "perf" in STATUS_FILES
    ctx = Context(status_dir=str(tmp_path / "status"), device=CPU)
    monkeypatch.setenv("PERF_QUICK", "true")
    values = run_component("perf", ctx)
    assert values["mxu-probe_ok"] == "true"
    assert "mxu_tflops" in values and values["chip_gen"] == "unknown"
    assert (tmp_path / "status" / "perf-ready").exists()
    assert (tmp_path / "status" / "perf-report").exists()


def test_two_point_rate_cancels_fixed_overhead(monkeypatch):
    # fake clock: fixed 50ms overhead + 1ms per rep; true rate = work/1ms
    durations = {2: 0.052, 8: 0.058}
    clock = {"t": 0.0}

    def run(reps):
        clock["t"] += durations[reps]

    monkeypatch.setattr(mb.time, "perf_counter", lambda: clock["t"])
    rate = mb._two_point_rate(run, work_per_rep=1000.0, r1=2, r2=8)
    assert abs(rate - 1_000_000) < 1.0, rate


def test_microbench_cli_needs_the_card(capsys):
    """The CLI runs on the card; without one every probe reports failure
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert mb.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert not any('"ok": true' in line for line in lines)

