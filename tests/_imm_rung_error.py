"""The stage ladder's K = 4 ``imm_scan`` rung's distance from the float64
oracle on the CPU, beside the JAX package's at the same contract: the
lanes ``chip_smoke.py`` phase 5b holds (N_SAMPLE of the pod's 131,072,
T = 300, the maneuvering replay stream), at symmetrize False and True,
for the port's plain version, the reference's ``katana_imm_sequence``
(interpret mode) and the float32 oracle. Each distance is the largest
|d| / max(1, |float64|).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_imm_rung_error.py

About 4 minutes, most of it the reference's two interpret-mode scans."""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                    "src")]

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro.core import filters as jf  # noqa: E402
from repro.kernels.katana_bank import ops as jops  # noqa: E402
from repro_torch.core import ref as oracle  # noqa: E402
from repro_torch.kernels.katana_bank import ops  # noqa: E402


def main():
    imm = cs.replay_model("imm")
    zs, x0, P0 = cs.replay_stream("imm")
    pick = np.sort(np.random.default_rng(3).choice(zs.shape[1], cs.N_SAMPLE,
                                                   replace=False))
    z, x, P = zs[:, pick], x0[pick], P0[pick]
    exact = oracle.run_imm_batched(imm, z.astype(np.float64), x, P)[0]

    def dist(a):
        """The largest distance, and its (frame, lane, dim) and |float64|
        there."""
        r = (np.abs(np.asarray(a, np.float64) - exact)
             / np.maximum(1.0, np.abs(exact)))
        at = np.unravel_index(int(r.argmax()), r.shape)
        return (f"{r.max():.3g} (frame {at[0]}, lane {at[1]}, dim {at[2]}, "
                f"|ref| {abs(exact[at]):.3g})")

    f32 = oracle.run_imm_batched(imm, z.astype(np.float64), x, P,
                                 dtype=np.float32)[0]
    print(f"float32 oracle: {dist(f32)}")
    for sym in (False, True):
        port = ops.katana_imm_sequence(imm, torch.as_tensor(z),
                                       torch.as_tensor(x),
                                       torch.as_tensor(P), symmetrize=sym)
        want = jops.katana_imm_sequence(jf.make_imm(), jnp.asarray(z),
                                        jnp.asarray(x), jnp.asarray(P),
                                        symmetrize=sym)
        print(f"symmetrize={sym}: the port's plain version "
              f"{dist(port.numpy())}; the reference {dist(want)}")


if __name__ == "__main__":
    main()
