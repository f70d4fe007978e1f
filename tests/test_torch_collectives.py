"""Parity of the port's multi-device validator with the JAX package.

The port runs on 8 gloo ranks on the CPU (``_dist.spawn``), the JAX package
on its 8-device virtual CPU mesh (``tests/conftest.py``), each case as
``tests/test_workloads.py`` runs it.  Two spawns for the whole file, one per
mesh family (module fixtures); the rank functions are in
``tests/torch_dist_ranks.py``.  Each case holds the port's report against
the JAX report: the name, ``ok``, ``value`` and every number in ``detail``
(exact, but for the attention errors and the pipeline's, which only have to
sit under the checks' own gates, and the bandwidth, timed).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks
import torch_keymap as km
from tpu_operator.validator import workloads as jwl
from tpu_operator_torch.validator import _dist, workloads as wl

_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _numbers(detail):
    return [float(x) for x in _NUMBER.findall(detail)]


def _same(port, jrep, tol=0.0):
    assert port.name == km.rename(jrep.name)
    assert port.ok == jrep.ok, (port.detail, jrep.detail)
    if jrep.value is None:
        assert port.value is None
    else:
        assert port.value == pytest.approx(jrep.value, abs=tol)
    assert _numbers(port.detail) == pytest.approx(_numbers(jrep.detail),
                                                  abs=tol), (port.detail,
                                                             jrep.detail)


def _jax_qkv(seed, shape):
    """The q, k, v the JAX attention checks draw (same keys, same order)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.asarray(jax.random.normal(key, shape, jnp.float32))
                 for key in keys)


def _attention(q, k, v):
    s = (q @ k.T) / np.sqrt(q.shape[1])
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v


def _attention_heads(q, k, v):
    return np.stack([_attention(q[:, h], k[:, h], v[:, h])
                     for h in range(q.shape[1])], axis=1)


TRAIN_STEPS = 3


def _jax_train():
    """The JAX step's weights and batch on the (4, 2) mesh as numpy, and its
    weights and losses after TRAIN_STEPS steps."""
    step, params, (x, y) = jwl.sharded_train_step(jwl.make_mesh(shape=(4, 2)))
    start = {k: np.asarray(v) for k, v in params.items()}
    losses = []
    for _ in range(TRAIN_STEPS):
        loss, params = step(params, x, y)
        losses.append(float(loss))
    return start, np.asarray(x), np.asarray(y), \
        {k: np.asarray(v) for k, v in params.items()}, losses


@pytest.fixture(scope="module")
def jax_train():
    return _jax_train()


@pytest.fixture(scope="module")
def ring_inputs_2d():
    return _jax_qkv(7, (4 * 32, 32)), _jax_qkv(11, (4 * 32, 4, 16))


@pytest.fixture(scope="module")
def ring_inputs_flat():
    return _jax_qkv(7, (8 * 16, 16)), _jax_qkv(11, (8 * 16, 8, 16))


@pytest.fixture(scope="module")
def port_2d(ring_inputs_2d, jax_train):
    start, x, y, _, _ = jax_train
    return _dist.spawn(8, torch_dist_ranks.mesh_2d, "cpu", *ring_inputs_2d,
                       (start, x, y, jax_train[3], TRAIN_STEPS))


@pytest.fixture(scope="module")
def port_flat(ring_inputs_flat):
    return _dist.spawn(8, torch_dist_ranks.mesh_flat, "cpu", *ring_inputs_flat)


# --------------------------------------------------------------------------
# mesh construction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_matches_jax(n):
    assert wl.default_mesh_shape(n) == \
        jwl.make_mesh(devices=jax.devices()[:n]).devices.shape


def test_make_mesh_default_and_rejected_shape(port_2d):
    mesh = jwl.make_mesh()
    assert port_2d["default_shape"] == mesh.devices.shape == (4, 2)
    # rank r at r's row-major coordinate, as jax.devices() fills the mesh
    assert port_2d["default_layout"] == \
        [[d.id for d in row] for row in mesh.devices]
    with pytest.raises(ValueError, match="does not cover") as jax_err:
        jwl.make_mesh(shape=(3, 2))
    assert port_2d["bad_shape"] == str(jax_err.value)


# --------------------------------------------------------------------------
# collective checks
# --------------------------------------------------------------------------

def test_psum_matches_jax(port_2d):
    _same(port_2d["psum"], jwl.ici_psum_check(jwl.make_mesh(shape=(4, 2))))


@pytest.mark.parametrize("family", ["flat", "2d"])
def test_ring_matches_jax(family, port_flat, port_2d):
    if family == "flat":
        port = port_flat["ring"]
        jrep = jwl.ici_ring_check(
            jwl.make_mesh(shape=(8,), axis_names=("data",)))
    else:
        port = port_2d["ring"]
        jrep = jwl.ici_ring_check(jwl.make_mesh(shape=(4, 2)), axis="data")
    assert jrep.ok
    _same(port, jrep)


def test_all_gather_matches_jax(port_2d):
    _same(port_2d["all_gather"],
          jwl.ici_all_gather_check(jwl.make_mesh(shape=(4, 2))))


def test_bandwidth_probe_reads_a_finite_rate(port_2d):
    port = port_2d["bandwidth"]
    jrep = jwl.ici_bandwidth_probe(jwl.make_mesh(shape=(4, 2)),
                                   mib_per_device=1)
    assert port.ok and jrep.ok
    assert np.isfinite(port.value) and port.value > 0 and jrep.value > 0
    # the timed rate aside, the same devices and size
    assert _numbers(port.detail)[1:] == _numbers(jrep.detail)[1:]


@pytest.mark.parametrize("processes", [4, 8, 0, 3],
                         ids=["gang-4", "flat-8", "default", "rejects-3"])
def test_multihost_allreduce_matches_jax(processes, port_2d):
    jrep = jwl.multihost_allreduce_check(processes=processes)
    assert jrep.ok == (processes != 3)
    port = port_2d[f"multihost_{processes}"]
    if processes == 3:
        assert "not divisible" in port.detail
        assert port.detail == jrep.detail
    else:
        assert "virtual process(es) x" in port.detail
    _same(port, jrep)


@pytest.mark.parametrize("family", ["flat", "2x4-expert"])
def test_ep_all_to_all_matches_jax(family, port_flat, port_2d):
    if family == "flat":
        port, jrep = port_flat["ep"], jwl.ep_all_to_all_check()
    else:
        port = port_2d["ep"]
        jrep = jwl.ep_all_to_all_check(
            jwl.make_mesh(shape=(2, 4), axis_names=("data", "expert")))
    assert jrep.ok
    _same(port, jrep)


@pytest.mark.parametrize("case", ["8-stages", "rejects-2-axis"])
def test_pp_pipeline_matches_jax(case, port_2d):
    if case == "8-stages":
        port, jrep = port_2d["pp"], jwl.pp_pipeline_check()
        assert jrep.ok and port.value == 8
    else:
        port = port_2d["pp_2axis"]
        jrep = jwl.pp_pipeline_check(jwl.make_mesh(shape=(4, 2)))
        assert not jrep.ok and port.detail == jrep.detail
    # both under the check's own 1e-5 gate
    _same(port, jrep, tol=1e-5)


@pytest.mark.parametrize("n_slices", [2, 4, 3])
def test_dcn_multislice_matches_jax(n_slices, port_2d):
    jrep = jwl.dcn_multislice_check(n_slices=n_slices)
    assert jrep.ok == (n_slices != 3)
    port = port_2d[f"dcn_{n_slices}"]
    if n_slices == 2:
        assert "2 slices x 4 hosts" in port.detail
    _same(port, jrep)


@pytest.mark.parametrize("check", [
    "ici_psum_check", "ici_ring_check", "ici_all_gather_check",
    "multihost_allreduce_check", "ep_all_to_all_check", "pp_pipeline_check",
    "ring_attention_check", "ulysses_attention_check",
    "dcn_multislice_check", "slice_burn_in"])
def test_check_warms_its_groups_before_its_clock(check):
    """NCCL sets a group's communicator up at its first collective: each
    check's window must start after one untimed collective on its mesh."""
    src = inspect.getsource(getattr(wl, check))
    assert "_warm(mesh)" in src
    assert src.index("_warm(mesh)") < src.index("t0 = _clock(")


def test_collective_spelling_is_not_deprecated():
    for fn in (_dist.all_gather_into, _dist.reduce_scatter_into):
        assert getattr(fn, "__deprecated__", None) is None, fn.__name__


@pytest.mark.parametrize("check", ["all_gather", "dcn"])
def test_older_collective_spelling_matches_jax(check, port_flat):
    """The checks through the older names of the renamed collectives, the
    spelling a torch without ``*_single`` runs, against JAX."""
    older = port_flat["older"]
    assert older["names"] == ["all_gather_into_tensor",
                              "reduce_scatter_tensor"]
    if check == "all_gather":
        jrep = jwl.ici_all_gather_check(jwl.make_mesh(shape=(4, 2)))
    else:
        jrep = jwl.dcn_multislice_check(n_slices=2)
    assert jrep.ok
    _same(older[check], jrep)


# --------------------------------------------------------------------------
# attention: the reports, and the gathered output itself on JAX's inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["4x2", "8x1"])
def test_ring_attention_matches_jax(family, port_2d, port_flat,
                                    ring_inputs_2d, ring_inputs_flat):
    if family == "4x2":
        port, inputs = port_2d, ring_inputs_2d[0]
        jrep = jwl.ring_attention_check(jwl.make_mesh(shape=(4, 2)))
    else:
        port, inputs = port_flat, ring_inputs_flat[0]
        jrep = jwl.ring_attention_check(jwl.make_mesh(shape=(8, 1)),
                                        seq_per_device=16, d_head=16)
    assert jrep.ok and port["ring_attention"].ok
    _same(port["ring_attention"], jrep, tol=1e-4)
    out = port["ring_attention_out"]
    assert out.shape == inputs[0].shape
    assert np.max(np.abs(out - _attention(*inputs))) <= 1e-4


@pytest.mark.parametrize("family", ["4x2", "8x1"])
def test_ulysses_attention_matches_jax(family, port_2d, port_flat,
                                       ring_inputs_2d, ring_inputs_flat):
    if family == "4x2":
        port, inputs = port_2d, ring_inputs_2d[1]
        jrep = jwl.ulysses_attention_check(jwl.make_mesh(shape=(4, 2)))
    else:
        port, inputs = port_flat, ring_inputs_flat[1]
        jrep = jwl.ulysses_attention_check(jwl.make_mesh(shape=(8, 1)),
                                           seq_per_device=16, d_head=16)
    assert jrep.ok and port["ulysses"].ok
    _same(port["ulysses"], jrep, tol=1e-4)
    # a head/sequence mix-up in the exchanges still passes softmax sanity
    # checks; only the output itself shows it
    out = port["ulysses_out"]
    assert out.shape == inputs[0].shape
    assert np.max(np.abs(out - _attention_heads(*inputs))) <= 1e-4


# --------------------------------------------------------------------------
# the sharded train step, the burn-in and the full chain
# --------------------------------------------------------------------------

def test_sharded_train_step_matches_jax(port_2d, jax_train):
    """Three dp×tp steps of each, from the JAX package's weights and batch.
    Measured on the CPU with the products on the matmul wrapper (its plain
    version, the backward's cotangent split into three bf16 terms): losses
    within 1.08e-6 relative, updated weights within 3.05e-7 (they moved
    4.4e-4).  With the products in plain f32 it was 1.1e-6 / 3.1e-7;
    leaving the gradients unrounded gave 3.9e-6 / 7.0e-7, rounding each
    data shard's before the sum 7.4e-6 / 8.9e-7: JAX rounds the summed
    gradient to bf16, as the port does."""
    got = port_2d["train"]
    np.testing.assert_allclose(got["losses"], jax_train[4], rtol=1e-4)
    assert got["param_gap"] <= 1e-4
    assert all(b < a for a, b in zip(got["losses"], got["losses"][1:]))


def test_sharded_train_step_calls_the_matmul_five_times_per_rank(port_2d):
    """Every product of a step goes through the matmul kernel's wrapper:
    two forward, three backward (dW2, dh, dW1; none for x), on each of the
    8 ranks."""
    assert port_2d["step_matmul_calls"] == [5] * 8


def test_sharded_train_step_loss_decreases(port_2d):
    l0, l1 = port_2d["small_step_losses"]
    assert np.isfinite(l0) and l1 < l0


def test_slice_burn_in(port_2d):
    port = port_2d["slice_burn_in"]
    jrep = jwl.slice_burn_in(jwl.make_mesh(shape=(4, 2)), steps=3)
    assert port.ok and jrep.ok, port.detail
    assert port.name == km.rename(jrep.name) and "→" in port.detail


def test_run_full_validation_quick_matches_jax(port_2d):
    port = port_2d["full"]
    jax_reports = jwl.run_full_validation(quick=True)
    assert [r.name for r in port] == [km.rename(r.name) for r in jax_reports]
    assert "multihost-allreduce" in [r.name for r in port]
    assert all(r.ok for r in port), [(r.name, r.detail) for r in port]
    assert all(r.ok for r in jax_reports)


# --------------------------------------------------------------------------
# one verdict on every rank
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(torch_dist_ranks.AGREE_CASES))
def test_agree_gives_every_rank_the_worst(case, port_flat):
    oks, values, worst = torch_dist_ranks.AGREE_CASES[case]
    held = port_flat["agree"][case]
    assert len(set(map(repr, held))) == 1          # the same on every rank
    ok, value, duration = held[0]
    assert ok == all(oks) and duration == 7.0
    if case == "nan":
        assert np.isnan(value)
    elif case == "none":
        assert value is None
    else:
        assert value == worst(values)


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(_dist.DistributedError, match="rank 1 fails"):
        _dist.spawn(2, torch_dist_ranks.fail_on_rank_1, "cpu")


def test_spawn_names_the_failing_rank_ahead_of_a_lost_peer():
    """Rank 0 fails first, with a transport error, because rank 1 failed:
    the message leads with rank 1's own error and marks rank 0's."""
    with pytest.raises(_dist.DistributedError) as info:
        _dist.spawn(2, torch_dist_ranks.fail_on_rank_1_while_0_collects,
                    "cpu")
    msg = str(info.value)
    assert msg.startswith("2 rank(s) of 2 failed: rank 1: SlowToReport: "
                          "rank 1 fails; rank 0: RuntimeError: "), msg
    assert "(a lost peer)" in msg.splitlines()[0]
    assert "SlowToReport" in msg.split("\n", 1)[1]
