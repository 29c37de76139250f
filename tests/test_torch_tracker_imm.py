"""The port's IMM tracker against the JAX package over a 60-frame
lifecycle (identical association and ids, states, mode probabilities
and combined estimates within 5e-4), and the K=1 IMM frame reduces
bitwise to the single-model frame (EKF member included)."""
import numpy as np
import torch

from repro_torch.core import bank as tb
from repro_torch.core import tracker as ttr
from repro_torch.core.filters import as_imm, get_filter
from repro_torch.data import trajectories as tt

from test_torch_tracker import CFG_T, run_against_jax


def test_imm_fused_lifecycle_matches_jax():
    run_against_jax("imm", seed=17)


def test_imm_k1_reduces_bitwise_to_single_frame():
    model = get_filter("ekf")
    imm1 = as_imm(model)
    cfg = tt.SceneConfig(T=25, max_targets=3, max_meas=16, clutter_rate=0.4,
                         death_rate=0.0)
    z, valid, _ = tt.mot_scene(model, cfg, seed=3)
    bi = tb.init_imm_bank(imm1, CFG_T.capacity, device="cpu")
    bs = tb.init_bank(model, CFG_T.capacity, device="cpu")
    for t in range(cfg.T):
        zt = torch.as_tensor(z[t], dtype=torch.float32)
        vt = torch.as_tensor(valid[t])
        ri = ttr.imm_frame_step(imm1, CFG_T, bi, zt, vt)
        rs = ttr.frame_step(model, CFG_T, bs, zt, vt)
        assert torch.equal(ri.assoc, rs.assoc)
        assert torch.equal(ri.bank.x[0], rs.bank.x)
        assert torch.equal(ri.bank.P[0], rs.bank.P)
        assert torch.equal(ri.bank.mu, torch.ones_like(ri.bank.mu))
        np.testing.assert_array_equal(ri.x_est.numpy(), rs.bank.x.numpy())
        bi, bs = ri.bank, rs.bank
    assert int(bs.next_id) >= 3
