"""Training in the port (``repro_torch.optim``, ``distributed``,
``launch.steps.make_train_step``, ``launch.train``) on the CPU.

Twins of the reference's substrate tests (``tests/test_substrates.py``:
AdamW on a quadratic, global-norm clipping, error feedback keeping the
signal, a crash at step 12 that restores from step 10 and still learns)
and of its per-arch train smoke test (``tests/test_archs_smoke.py``) for
every arch (the frontend archs fed embeddings); loss and gradients bit
for bit across remat none, full and selective; and the port's train step
against the reference's on reduced h2o-danube-1.8b (``attn_impl="flash"``,
the reference's Pallas kernel in interpret mode), reduced mamba2-130m and
reduced granite-moe-1b-a400m (MoE at "factor" capacity, the aux loss),
both packages starting from the same ``TrainState``
(``convert.train_state_from_numpy``) and taking the same batches. At
float32 compute: the first step's clipped gradients (read from the first
moment, m = (1 - b1) g after one step) within 1e-5 of each leaf's max |g|
of a float64 oracle (the port's own model run with ``Tensor.float``
giving float64), and within 2e-5 of the reference's (the SSM's ``D``,
a sum over B x S x P terms that nearly cancel, parts by 1.5e-5 because
the two packages sit ~9e-6 from the oracle on opposite sides); grad_norm
and lr within 1e-6 relative, the loss curve over 5 steps within 1e-4
relative; at the default bf16 compute the loss curve within 1e-2
relative. granite-moe at float32: the first step's clipped gradients
within 1e-5 of each leaf's max |g| of the reference's and of the float64
oracle, the loss, aux and grad_norm within 1e-4 relative over 5 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.lm import LMDataPipeline as JData
from repro.distributed.compression import ef_compress as j_ef_compress
from repro.launch.steps import make_train_step as j_train_step
from repro.models import model as j_model
from repro.optim import adamw as j_adamw
from repro.sharding.rules import ShardingContext as JCtx
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import RunConfig, get_config, list_archs, reduced
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.lm import LMDataPipeline
from repro_torch.distributed.compression import ef_compress
from repro_torch.launch import train as train_lib
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.runtime.ft import TrainSupervisor
from repro_torch.sharding.rules import ShardingContext

from _torch_parity import np_


# -- twins of tests/test_substrates.py:37-66 -------------------------------

def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_train_state(params)
    for _ in range(300):
        g = {"w": 2 * state.master["w"]}
        state = adamw.adamw_update(state, g, 0.05, weight_decay=0.0)
    assert float(state.master["w"].abs().max()) < 0.1
    assert int(state.step) == 300 and state.step.dtype == torch.int32
    assert float(params["w"][0]) == 3.0  # the master is a copy


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_ef_compress_preserves_signal():
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.normal(size=(64,)), dtype=torch.float32)}
    ef = {"w": torch.zeros(64)}
    acc_true, acc_deq = np.zeros(64), np.zeros(64)
    for _ in range(30):
        deq, ef = ef_compress(g, ef)
        acc_true += np_(g["w"])
        acc_deq += np_(deq["w"])
    rel = np.abs(acc_deq - acc_true).max() / np.abs(acc_true).max()
    assert rel < 0.02  # error feedback keeps the long-run estimate tight


def test_optimizer_pieces_match_the_reference():
    """AdamW (three steps), clipping, the schedule and ef_compress on the
    same float32 inputs: within 1e-6 relative (XLA may contract a*b + c)."""
    rng = np.random.default_rng(1)
    w = {"a": rng.normal(size=(3, 5)).astype(np.float32),
         "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    gs = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32)
                       * 3, w) for _ in range(3)]
    js = j_adamw.init_train_state(jax.tree.map(jnp.asarray, w))
    ts = adamw.init_train_state(jax.tree.map(torch.as_tensor, w))
    for i, g in enumerate(gs):
        jg, jn = j_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                             1.0)
        tg, tn = adamw.clip_by_global_norm(
            jax.tree.map(torch.as_tensor, g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        lr_j = j_adamw.warmup_cosine(js.step, 1e-2, 2, 10)
        lr_t = adamw.warmup_cosine(ts.step, 1e-2, 2, 10)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
        js = j_adamw.adamw_update(js, jg, lr_j)
        ts = adamw.adamw_update(ts, tg, lr_t)
    for jl, tl in zip(jax.tree.leaves(js.master),
                      adamw.tree_leaves(ts.master)):
        np.testing.assert_allclose(np_(tl), np.asarray(jl), rtol=1e-6,
                                   atol=1e-7)
    ef = jax.tree.map(np.zeros_like, w)
    jd, je = jax.tree.map(np.asarray, jax.jit(j_ef_compress)(gs[0], ef))
    td, te = ef_compress(jax.tree.map(torch.as_tensor, gs[0]),
                         jax.tree.map(torch.as_tensor, ef))
    for a, b in zip(jax.tree.leaves(jd), adamw.tree_leaves(td)):
        np.testing.assert_allclose(np_(b), a, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(je), adamw.tree_leaves(te)):
        np.testing.assert_allclose(np_(b), a, atol=1e-6)


# -- twin of tests/test_substrates.py:102-145 ------------------------------

def test_train_step_decreases_loss_and_resumes(tmp_path):
    """A real train loop on reduced granite-moe: the loss falls; a crash
    at step 12 restores from the step-10 checkpoint and goes on."""
    cfg = reduced(get_config("granite-moe-1b-a400m"), n_layers=2,
                  d_model=64, vocab=64, seq=32)
    run = RunConfig(microbatches=2, learning_rate=3e-3, warmup_steps=5,
                    total_steps=40, remat="none")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    state = adamw.init_train_state(params)
    data = LMDataPipeline(cfg.vocab, 32, 8, seed=1, microbatches=2)
    step_fn = make_train_step(cfg, run, ShardingContext())
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), keep_n=2)

    holder = {"state": state}
    losses = []
    crash_at = 12

    def one_step(i):
        if i == crash_at and not one_step.crashed:
            one_step.crashed = True
            raise RuntimeError("induced host failure")
        holder["state"], m = step_fn(holder["state"], data.next_batch())
        losses.append(float(m["loss"]))
        if (i + 1) % 5 == 0:
            mgr.save(i + 1, holder["state"],
                     {"step": i + 1, "data": data.state_dict()},
                     blocking=True)

    one_step.crashed = False

    def restore():
        holder["state"], extra = mgr.restore_latest(holder["state"])
        data.load_state_dict(extra["data"])
        return int(extra["step"])

    sup = TrainSupervisor(one_step, restore, 25, max_restarts=2)
    report = sup.run()
    assert report.restarts == 1
    assert report.restored_steps == [10]
    assert losses[-1] < losses[0]  # it actually learns
    assert int(holder["state"].step) >= 25


# -- twin of tests/test_archs_smoke.py:50 -----------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_train_step_smoke(arch):
    cfg = reduced(get_config(arch), seq=32)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    for leaf in adamw.tree_leaves(params):
        leaf.requires_grad_()
    rng = np.random.default_rng(1)
    # the reference's make_batch: the vision stub's patch positions before
    # the text, every position from the audio stub
    n_front = 32 if cfg.frontend == "audio" else cfg.frontend_positions
    batch = {"labels": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)))}
    if cfg.frontend:
        batch["embeds"] = torch.as_tensor(
            rng.normal(size=(2, n_front, cfg.d_model))).bfloat16()
    if n_front < 32:
        batch["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab, (2, 32 - n_front)))
    loss, metrics = model_lib.loss_fn(params, cfg, batch)
    # a leaf the batch never reaches (hubert's token table) gets zeros, as
    # jax.grad gives
    grads = torch.autograd.grad(loss, adamw.tree_leaves(params),
                                allow_unused=True, materialize_grads=True)
    assert np.isfinite(float(loss.detach())), arch
    assert np.isfinite(float(metrics["ce"].detach()))
    assert all(torch.isfinite(g.float()).all() for g in grads)
    assert any(float(g.float().abs().max()) > 0 for g in grads)


# -- remat ------------------------------------------------------------------

@pytest.mark.parametrize("arch,attn_impl", [("h2o-danube-1.8b", "flash"),
                                            ("h2o-danube-1.8b", "full"),
                                            ("mamba2-130m", "auto")])
def test_remat_is_bit_for_bit(arch, attn_impl):
    """Tolerance: none. remat none, full and selective give the same loss
    and gradients on the CPU (recompute reruns the same ops)."""
    cfg = reduced(get_config(arch), seq=32)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(2),
                                   "cpu", torch.float32)
    leaves = adamw.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)))
             for k in ("tokens", "labels")}
    ctx = ShardingContext(attn_impl=attn_impl)
    out = {}
    for remat in ("none", "full", "selective"):
        loss, _ = model_lib.loss_fn(params, cfg, batch, ctx, remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("full", "selective"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


# -- the port's train step against the reference's ---------------------------

B, S, MB, STEPS = 4, 32, 2, 5


def _cfgs(arch):
    jcfg = j_reduced(j_get_config(arch), seq=S)
    cfg = reduced(get_config(arch), seq=S)
    if arch == "h2o-danube-1.8b":  # GQA: 4 query heads on 2 kv heads
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
            jcfg.attention, n_kv_heads=2))
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, n_kv_heads=2))
    return jcfg, cfg


RUN = dict(microbatches=MB, learning_rate=1e-2, warmup_steps=2,
           total_steps=STEPS, remat="none")


def _clipped_grads64(cfg, master, batch, attn_impl, monkeypatch):
    """The first step's clipped gradients in float64: the port's model on
    float64 copies of ``master`` with ``Tensor.float`` giving float64,
    the microbatch gradients averaged and clipped to norm 1."""
    p64 = adamw.tree_map(lambda t: t.detach().to(torch.float64), master)
    leaves = adamw.tree_leaves(p64)
    for leaf in leaves:
        leaf.requires_grad_()
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float",
                   lambda self: self.to(torch.float64))
        gsum = [torch.zeros_like(leaf) for leaf in leaves]
        for i in range(MB):
            mb = {k: torch.as_tensor(v[i]).long() for k, v in batch.items()}
            loss, _ = model_lib.loss_fn(p64, cfg, mb,
                                        ShardingContext(attn_impl=attn_impl),
                                        "none")
            for a, g in zip(gsum, torch.autograd.grad(loss, leaves)):
                a += g
    g = [np_(a) / MB for a in gsum]
    norm = np.sqrt(sum((x * x).sum() for x in g))
    return [x * min(1.0, 1.0 / norm) for x in g]


def _train_both(arch, attn_impl, compute, monkeypatch=None):
    """Both packages from the same TrainState over the same STEPS
    batches. Returns (reference metrics, port metrics, (reference m,
    port m) after step 1, the float64 clipped gradients of step 1 when
    ``monkeypatch`` is given)."""
    jcfg, cfg = _cfgs(arch)
    jstate = j_adamw.init_train_state(j_model.init_params(jcfg,
                                                          jax.random.key(0)))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   "cpu")
    jstep = jax.jit(j_train_step(jcfg, JRun(**RUN), JCtx(None,
                                                         attn_impl=attn_impl),
                                 compute_dtype=getattr(jnp, compute)))
    step = make_train_step(cfg, RunConfig(**RUN),
                           ShardingContext(attn_impl=attn_impl),
                           compute_dtype=getattr(torch, compute))
    jdata = JData(jcfg.vocab, S, B, seed=3, microbatches=MB)
    data = LMDataPipeline(cfg.vocab, S, B, seed=3, microbatches=MB)
    g64 = None if monkeypatch is None else _clipped_grads64(
        cfg, state.master, LMDataPipeline(cfg.vocab, S, B, seed=3,
                                          microbatches=MB).next_batch(),
        attn_impl, monkeypatch)
    jm, tm, first = [], [], None
    for i in range(STEPS):
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in jdata.next_batch().items()})
        jm.append({k: float(v) for k, v in m.items()})
        state, m = step(state, data.next_batch())
        tm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = (jax.tree.map(np.asarray, jstate.m),
                     adamw.tree_map(lambda t: np_(t).copy(), state.m))
    return jm, tm, first, g64


@pytest.mark.parametrize("arch,attn_impl", [("h2o-danube-1.8b", "flash"),
                                            ("mamba2-130m", "auto")])
def test_train_step_matches_the_reference_float32(arch, attn_impl,
                                                  monkeypatch):
    jm, tm, (jm1, tm1), g64 = _train_both(arch, attn_impl, "float32",
                                          monkeypatch)
    # m = (1 - b1) g after the first step: the clipped gradients
    for jl, tl, ol in zip(jax.tree.leaves(jm1), adamw.tree_leaves(tm1),
                          g64):
        g_j, g_t = jl / 0.1, tl / 0.1
        scale = max(np.abs(ol).max(), 1e-30)
        assert np.abs(g_t - ol).max() <= 1e-5 * scale
        assert np.abs(g_t - g_j).max() <= 2e-5 * scale
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-6)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
    np.testing.assert_allclose([t["loss"] for t in tm],
                               [j["loss"] for j in jm], rtol=1e-4)


@pytest.mark.parametrize("arch,attn_impl", [("h2o-danube-1.8b", "flash"),
                                            ("mamba2-130m", "auto")])
def test_train_step_matches_the_reference_bfloat16(arch, attn_impl):
    jm, tm, _, _ = _train_both(arch, attn_impl, "bfloat16")
    np.testing.assert_allclose([t["loss"] for t in tm],
                               [j["loss"] for j in jm], rtol=1e-2)


def test_moe_train_step_matches_the_reference_float32(monkeypatch):
    """Reduced granite-moe (4 experts, top-2, "factor" capacity in
    training), both packages from the same TrainState."""
    jm, tm, (jm1, tm1), g64 = _train_both("granite-moe-1b-a400m", "auto",
                                          "float32", monkeypatch)
    leaves = list(zip(jax.tree.leaves(jm1), adamw.tree_leaves(tm1), g64))
    assert len(leaves) == len(adamw.tree_leaves(tm1))
    for jl, tl, ol in leaves:
        g_j, g_t = jl / 0.1, tl / 0.1
        scale = max(np.abs(g_j).max(), 1e-30)
        assert np.abs(g_t - g_j).max() <= 1e-5 * scale
        assert np.abs(g_t - ol).max() <= 1e-5 * max(np.abs(ol).max(), 1e-30)
    assert all(t["aux"] > 0 for t in tm)
    for key in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose([t[key] for t in tm],
                                   [j[key] for j in jm], rtol=1e-4)


def test_launcher_trains_moe_on_the_cpu(capsys):
    """``launch/train.py --arch granite-moe-1b-a400m --reduced``: the
    loss falls in 12 steps."""
    losses = train_lib.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--steps", "12", "--seq", "32", "--batch", "4",
                             "--lr", "3e-3", "--device", "cpu"])
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert "done: 12 steps" in capsys.readouterr().out


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``launch/train.py`` end to end on --device cpu --reduced with
    checkpoints and a resume: the loss falls, the resume picks up the
    last checkpoint."""
    argv = ["--arch", "mamba2-130m", "--reduced", "--steps", "12", "--seq",
            "32", "--batch", "4", "--lr", "3e-3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"]
    losses = train_lib.main(argv)
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert ckpt_lib.available_steps(str(tmp_path)) == [6, 12]
    train_lib.main(argv[:4] + ["14"] + argv[5:] + ["--resume"])
    assert "resumed from step 12" in capsys.readouterr().out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train_lib.build(reduced(get_config("mamba2-130m")), RunConfig(), 8, 2)
