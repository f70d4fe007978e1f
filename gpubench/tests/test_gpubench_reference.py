"""The plain reference agrees with the port's CPU path at small sizes."""

import numpy as np
import pytest
import torch

from gpubench.reference import validator as ref


@pytest.fixture(scope="module")
def wl():
    from tpu_operator_torch.validator import workloads
    return workloads


@pytest.mark.parametrize("size, n", [(64, 1), (64, 37), (128, 5)])
def test_burn_in_checksum(wl, size, n):
    x, w = ref.burn_in_inputs(size, "cpu")
    got = float(wl._burn_in_fn(x, w, n))
    checksum, mass = ref.burn_in_answers(size, [n], "cpu")[n]
    assert abs(got - checksum) <= 1e-6 * mass
    assert mass > 0


def test_burn_in_control_departs(wl):
    x, w = ref.burn_in_inputs(64, "cpu")
    got = float(wl._burn_in_fn(x, w, 64))
    checksum, mass = ref.burn_in_answers(64, [64], "cpu", "fp8")[64]
    assert abs(got - checksum) > 1e-3 * mass


def _whole(kind, run):
    """The whole-state checksum the taps of ``kind`` record for one chain
    call made by ``run``."""
    from gpubench import manifest
    from gpubench.taps import Taps

    taps = Taps()
    manifest.kinds([kind])[kind].install(taps)
    try:
        run()
    finally:
        taps.remove()
    (answer,) = taps.answers
    return tuple(float(v) for v in answer.value)


@pytest.mark.parametrize("n", [1, 2, 128])
def test_stress(wl, n):
    b = torch.full((1024,), 1.5)
    c = torch.full((1024,), 2.0)
    got = _whole("stress", lambda: wl._triad_chain(b, c, n))
    assert got == ref.stress_answers(1024, [n], "cpu")[n]
    if n >= 64:
        # at the fixed point, 8/3 in bf16 is not its f32 value
        assert got != ref.stress_answers(1024, [n], "cpu", "bf16")[n]


@pytest.mark.parametrize("n", [1, 16, 64])
def test_triad(n):
    from tpu_operator_torch.validator import microbench, ops

    a = torch.full((4, 2048), 1.5)
    b = torch.full((4, 2048), 2.0)
    ops.triad_(a, b, 3.0)
    got = _whole("triad", lambda: microbench._triad_chain(a, b, 256, n))
    assert got == ref.triad_answers(a.numel(), [n], "cpu")[n]
    if n >= 64:
        assert got != ref.triad_answers(a.numel(), [n], "cpu", "bf16")[n]


def test_a_state_left_half_undone_reads_off():
    # the program's eight elements right, the rest of its array not
    from gpubench import manifest
    from gpubench.taps import Answer

    stress = manifest.kinds(["stress"])["stress"]
    want = ref.stress_answers(1024, [128], "cpu")[128]
    state = torch.full((1024,), want[0])
    assert stress.gaps(Answer("stress", 1024, 128, torch.stack(
        torch.aminmax(state)), 0, 0, 0), want) == {"stress_gap": 0.0}
    state[512:] = 1.5
    assert stress.gaps(Answer("stress", 1024, 128, torch.stack(
        torch.aminmax(state)), 0, 0, 0), want)["stress_gap"] > 0.4


def test_fma():
    from tpu_operator_torch.validator import ops

    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((64, 64), dtype=np.float32)
               for _ in range(3))
    got = ops.fma_relu(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = ref.fma_answer(64, 64)
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_train_steps(wl):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = wl.make_mesh()
        step, params, (x, y) = wl.sharded_train_step(mesh)
        start = {k: v.clone() for k, v in params.items()}
        losses = []
        for _ in range(3):
            loss, params = step(params, x, y)
            losses.append(float(loss))
    finally:
        dist.destroy_process_group()
    r_start, steps = ref.train_answers(3)
    for k in start:
        assert torch.equal(start[k], r_start[k])
    for got, (want, _) in zip(losses, steps):
        assert got == pytest.approx(want, rel=1e-5)
    for k in params:
        assert torch.allclose(params[k], steps[-1][1][k], rtol=0, atol=1e-6)
