"""Train a reduced LM of a family the port serves end to end:
data pipeline -> microbatched AdamW train loop -> async checkpoints ->
crash-restart supervisor. A few hundred steps drive the loss visibly
down on the synthetic stream.

  PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-130m \\
      --steps 200 [--device cpu]
  PYTHONPATH=src python examples/torch_train_lm.py --arch h2o-danube-1.8b \\
      --steps 150 --grad-compression --device cpu

The twin of ``examples/train_lm.py`` through ``repro_torch.launch.train``.
It trains on the card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions. It exits non-zero if the loss did not decrease.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--reduced" not in argv:
        argv.append("--reduced")
    losses = main(argv)
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
