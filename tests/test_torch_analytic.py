"""The port's analytic models equal the reference's float for float:
``models/counting.py`` and ``roofline/memmodel.py`` on every arch of
``list_archs()`` at every shape of ``ALL_SHAPES``, and
``roofline/analysis.py`` on the machine both packages share ("cpu"); the
port's H100 preset and its backend map."""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.configs.base import RunConfig as JRun
from repro.models import counting as jcount
from repro.roofline import analysis as jana
from repro.roofline import memmodel as jmem
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ALL_SHAPES, RunConfig
from repro_torch.models import counting
from repro_torch.roofline import analysis, memmodel

CASES = [(a, s.name) for a in list_archs() for s in ALL_SHAPES]
# (microbatches, remat, attn_kernel): the default run, and one that moves
# every term of the train and prefill byte counts
RUNS = [(1, "selective", "xla"), (4, "full", "flash"), (2, "none", "xla")]
# (n_chips, model_size) of analytic_bytes_dev
MESHES = [(1, 1), (16, 16)]


def _shapes(shapes):
    return {s.name: s for s in shapes}


def test_same_archs_and_shapes():
    assert list_archs() == jlist_archs()
    assert [dataclasses.astuple(s) for s in ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in J_SHAPES]


@pytest.mark.parametrize("arch,shape", CASES)
def test_counting_matches_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = _shapes(ALL_SHAPES)[shape], _shapes(J_SHAPES)[shape]
    assert counting.count_params(cfg) == jcount.count_params(jcfg)
    B, S = s.global_batch, s.seq_len
    for kind in ("train", "prefill", "decode"):
        assert counting.attention_flops(cfg, B, S, kind) == \
            jcount.attention_flops(jcfg, B, S, kind), kind
        assert counting.ssm_flops(cfg, B, S, kind) == \
            jcount.ssm_flops(jcfg, B, S, kind), kind
    assert counting.model_flops(cfg, s) == jcount.model_flops(jcfg, js)


@pytest.mark.parametrize("arch,shape", CASES)
def test_memmodel_matches_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = _shapes(ALL_SHAPES)[shape], _shapes(J_SHAPES)[shape]
    for mb, remat, attn in RUNS:
        run = RunConfig(microbatches=mb, remat=remat, attn_kernel=attn)
        jrun = JRun(microbatches=mb, remat=remat, attn_kernel=attn)
        for n_chips, model_size in MESHES:
            got = memmodel.analytic_bytes_dev(cfg, s, run, n_chips,
                                              model_size)
            want = jmem.analytic_bytes_dev(jcfg, js, jrun, n_chips,
                                           model_size)
            assert got == want, (mb, remat, attn, n_chips, model_size)
    assert memmodel._cache_bytes_dev(cfg, s, 16) == \
        jmem._cache_bytes_dev(jcfg, js, 16)


TERMS = [  # (flops, bytes, collective bytes, model flops)
    (1.0e12, 3.0e9, 0.0, 6.0e11), (5.0e9, 8.0e11, 2.0e8, 5.0e9),
    (0.0, 1.0, 0.0, 0.0), (7.25e14, 1.5e10, 4.0e10, 3.3e14)]


@pytest.mark.parametrize("case", ["terms_on", "model_flops_total",
                                  "extrapolate"])
def test_roofline_matches_reference_on_cpu(case):
    m, jm = analysis.MACHINES["cpu"], jana.MACHINES["cpu"]
    assert dataclasses.astuple(m) == dataclasses.astuple(jm)
    if case == "terms_on":
        for args in TERMS:
            got, want = analysis.terms_on(m, *args), jana.terms_on(jm, *args)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            for prop in ("dominant", "bound", "useful_fraction",
                         "roofline_fraction"):
                assert getattr(got, prop) == getattr(want, prop), prop
    elif case == "model_flops_total":
        for n, tokens in ((1.8e9, 32768.0), (4.0e8, 1.0), (2.2e10, 1.0e6)):
            for kind in ("train", "prefill", "decode"):
                assert analysis.model_flops_total(n, tokens, kind) == \
                    jana.model_flops_total(n, tokens, kind)
    else:
        c_p = {"flops": 3.0e12, "bytes": 1.0e9, "coll": 0.0}
        c_2p = {"flops": 5.5e12, "bytes": 1.7e9}
        for p, L in ((1, 24), (2, 48), (4, 94)):
            assert analysis.extrapolate(c_p, c_2p, p, L) == \
                jana.extrapolate(c_p, c_2p, p, L)


def test_h100_preset():
    h = analysis.MACHINES["h100"]
    assert (h.peak_flops, h.mem_bw) == (989e12, 3.35e12)
    # NVLink 4: 900 GB/s both ways, 450 GB/s a direction
    assert h.ici_bw == 450e9 == analysis.NVLINK_BW_BOTH_WAYS / 2
    assert analysis.machine_for_backend("cuda") is h
    assert analysis.machine_for_backend("cuda:0") is h
    assert analysis.machine_for_backend("cpu") is analysis.MACHINES["cpu"]
    assert analysis.machine_for_backend("mps") is analysis.MACHINES["cpu"]
    assert set(analysis.MACHINES) == {"h100", "cpu"}
    t = analysis.terms_from(989e12, 3.35e12, 450e9, 989e12)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 1.0)
    assert t.roofline_fraction == 1.0
    assert t == analysis.terms_on(h, 989e12, 3.35e12, 450e9, 989e12)
