"""The port's mesh paths in a 4-process ``gloo`` world on the CPU, held
against the JAX package on a mesh of 4 XLA host devices.

The module spawns the world once (``_torch_mesh_worker.worker`` on 4
ranks through ``repro_torch.launch.local_world``) and the reference once
(``_jax_mesh_reference.py`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), side by side,
from one numpy input file. A deadlock cannot hang the suite: after STALL
seconds in which the children use no CPU, or past the wall-clock
DEADLINE, every child is killed and the tests fail. The parametrised
tests then read both results.

The cases, on a ('data' 2, 'model' 2) mesh unless named:

  * ``apply_moe`` "gather" and "tp2d" at float32, swiglu and
    squared_relu, capacity "full" and "factor", with a router skewed to
    one expert so that "factor" drops entries: the local capacity of the
    gather path drops other entries than one device does, and its aux is
    the mean of the data blocks' estimates (atol 1e-5, rtol 1e-4, as
    ``tests/test_sharding.py:124``);
  * ``compressed_psum`` over 4 ranks, bit for bit with the reference and
    with its plain version; ``ef_compress`` on the mesh (each leaf's
    scale from the full tensor's max), bit for bit;
  * reduced granite-moe-1b-a400m ("gather" and "tp2d") and granite-20b
    (MQA, kv replicated; also a batch of 1, the cache's sequence over data
    + model) prefilled and decoded 4 steps with ``attn_impl="flash"``
    (the kernels' plain versions on the CPU), teacher-forced, the logits
    within 1e-5;
  * the SSM mixer and the frontends: reduced mamba2-130m (8 heads of 16
    over model) and jamba-1.5-large (Mamba-2, attention and MoE layers)
    prefilled and decoded 4 steps at B = 4 and B = 1, reduced internvl2-2b
    from patch embeddings and tokens, the same way, and every rank's
    caches the blocks ``cache_shardings`` names; reduced mamba2 at d 48
    on ('data' 1, 'model' 4), whose 6 heads do not divide the model axis
    and replicate; reduced hubert-xlarge's ``make_encode_step``, every
    position's logits within 1e-5;
  * reduced granite-moe trained 3 float32 steps on (2, 2), saved from the
    mesh, restored onto (4, 1) and onto (1, 4) bit for bit and trained 2
    more steps on each (``tests/test_sharding.py:150`` at 4 devices):
    metrics within 1e-5 relative, the master weights within 1e-5 of each
    leaf's largest entry; reduced mamba2 and jamba trained 3 steps and
    internvl2 2 (the frontend's FSDP projection) on (2, 2), to the same
    bars;
  * ``make_production_mesh`` refused in a world of 4.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import _mesh_cases as mc
from _torch_mesh_worker import make_inputs
from repro_torch.configs import get_config, reduced
from repro_torch.launch import local_world
from repro_torch.models import model as model_lib
from repro_torch.models.ssm import ssm_dims
from repro_torch.sharding import rules

HERE = os.path.dirname(os.path.abspath(__file__))
# The children need ~255 CPU seconds (the reference 211 over its threads,
# the 4 ranks 44; 65-85 s of wall time on an idle 8-core host), and a full
# run's six workers share the host with them, so the wall-clock deadline
# covers that CPU time at one core, and a deadlock shows as a stall.
DEADLINE = 300.0  # seconds of wall time for the world and the reference
STALL = 60.0      # seconds in which the children use no CPU: a deadlock


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    inputs = d / "inputs.npz"
    np.savez(inputs, **make_inputs(np.random.default_rng(0)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE,
         os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    t0 = time.monotonic()
    with open(d / "reference.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_jax_mesh_reference.py"),
             str(inputs), str(d / "reference.npz")], env=env, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
        try:
            port = local_world.run(
                "_torch_mesh_worker:worker", mc.WORLD,
                dict(inputs=str(inputs), outdir=str(d)), path=HERE,
                deadline=DEADLINE, stall=STALL)[0]
            cpu = local_world.cpu_seconds(ref.pid)
            hung, why = local_world.watch([ref], t0 + DEADLINE, STALL)
            if hung:
                pytest.fail(
                    f"the reference was stopped ({why}: {DEADLINE:.0f} s "
                    f"deadline, {STALL:.0f} s stall) after "
                    f"{time.monotonic() - t0:.0f} s, {cpu:.0f} CPU s when "
                    f"the world ended; load {os.getloadavg()}")
        finally:
            if ref.poll() is None:
                os.killpg(ref.pid, signal.SIGKILL)
                ref.wait()
    if ref.returncode != 0:
        pytest.fail("the reference failed:\n"
                    + (d / "reference.log").read_text()[-3000:])
    return port, dict(np.load(d / "reference.npz"))


@pytest.mark.parametrize("mode,act,cap", mc.MOE_CASES)
def test_apply_moe_on_the_mesh_matches_the_reference(results, mode, act,
                                                     cap):
    port, ref = results
    name = f"moe/{mode}/{act}/{cap}"
    np.testing.assert_allclose(port[name + "/out"], ref[name + "/out"],
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(port[name + "/aux"], ref[name + "/aux"],
                               atol=1e-5, rtol=1e-4)
    one, one_aux = port[name + "/one_device"], port[name + "/one_device_aux"]
    if mode == "gather" and cap == "factor":
        # the local queues (128 entries a data block, capacity 80) drop
        # other entries than one device's (256, capacity 160), and the aux
        # is the mean of the blocks' estimates: both packages differ from
        # one device alike
        assert np.abs(port[name + "/out"] - one).max() > 1e-3
        assert np.abs(ref[name + "/out"] - one).max() > 1e-3
        assert abs(float(port[name + "/aux"]) - float(one_aux)) > 1e-4
    elif mode == "tp2d":
        # tp2d's capacity and aux are the whole batch's: one device's
        np.testing.assert_allclose(port[name + "/out"], one, atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(port[name + "/aux"], one_aux, rtol=1e-5)


def test_compressed_psum_is_bit_for_bit(results):
    port, ref = results
    np.testing.assert_array_equal(port["psum"], ref["psum"])
    np.testing.assert_array_equal(port["psum"], port["psum_plain"])


def test_ef_compress_takes_the_full_tensors_max(results):
    port, ref = results
    keys = [k for k in ref if k.startswith("ef/")]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def _served(port, ref, name):
    steps = ["prefill"] + [f"decode{i}" for i in range(mc.DECODE_STEPS)]
    for s in steps:
        assert port[f"{name}/{s}"].shape == ref[f"{name}/{s}"].shape
        np.testing.assert_allclose(port[f"{name}/{s}"], ref[f"{name}/{s}"],
                                   atol=1e-5, rtol=1e-5, err_msg=s)
    assert bool(port[f"{name}/cache_blocks"])


@pytest.mark.parametrize("arch,B,mode", mc.LM_CASES + mc.SSM_FRONTEND_CASES)
def test_prefill_and_decode_on_the_mesh(results, arch, B, mode):
    _served(*results, f"lm/{arch}/{B}/{mode}")


def test_ssm_heads_that_do_not_divide_the_model_axis_replicate(results):
    hr = mc.HEADS_REPLICATED
    cfg = reduced(get_config(hr["arch"]), **dict(mc.LM_REDUCE,
                                                  d_model=hr["d_model"]))
    assert ssm_dims(cfg.ssm, cfg.d_model)[1] % hr["mesh"][1]
    ctx = rules.make_context(rules.AbstractMesh(hr["mesh"],
                                                ("data", "model")))
    ssm = model_lib.param_specs(cfg, ctx)["groups"]["layer0"]["ssm"]
    assert all("model" not in rules.spec_axes(s) for s in ssm.values())
    _served(*results, "heads")


def test_encode_on_the_mesh(results):
    """Reduced hubert's encode step: every position's logits over the whole
    vocab (the rank's 32 of 64 columns, or the frontend's matmul on a
    split projection, before the step gathered as the serve steps do)."""
    port, ref = results
    assert port["encode/logits"].shape == ref["encode/logits"].shape == (
        mc.ENCODE_B, mc.LM_REDUCE["seq"], mc.LM_REDUCE["vocab"])
    np.testing.assert_allclose(port["encode/logits"], ref["encode/logits"],
                               atol=1e-5, rtol=1e-5)


def _trained(port, ref, prefix, steps):
    for i in range(steps):
        for k in mc.TRAIN_METRICS:
            key = f"{prefix}/{i}/{k}"
            got, want = port[key], ref[key]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
    masters = [k for k in ref if k.startswith(f"{prefix}/master/")]
    assert masters
    for k in masters:
        err = np.abs(port[k] - ref[k]).max() / np.abs(ref[k]).max()
        assert err <= 1e-5, (k, err)


@pytest.mark.parametrize("arch,steps", mc.TRAIN_CASES)
def test_ssm_and_frontend_training_on_the_mesh(results, arch, steps):
    _trained(*results, f"ssm_train/{arch}", steps)


@pytest.mark.parametrize("leg", [leg for leg, _, _ in mc.TRAIN_LEGS])
def test_training_across_mesh_shapes(results, leg):
    port, ref = results
    _trained(port, ref, f"train/{leg}",
             dict((k, n) for k, _, n in mc.TRAIN_LEGS)[leg])
    if leg == "a":
        assert bool(port["train/a/saved_bitwise"])
    else:
        assert bool(port[f"train/{leg}/restored_bitwise"])


def test_production_mesh_needs_its_world(results):
    port, _ = results
    assert "needs 256 ranks" in str(port["production_mesh_refused"])
