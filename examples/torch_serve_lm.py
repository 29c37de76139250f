"""LM serving demo of the PyTorch/CUDA port: batched prefill ->
autoregressive decode with the KV / SSM caches, on a reduced config of
any assigned arch.

Greedy-decodes continuations for a batch of random prompts and reports
prefill and per-token decode latency. Attention runs on the port's
kernels: ``flash_attention`` in the prefill, ``flash_decode`` in every
decode step (``ShardingContext(attn_impl="flash")``).

  PYTHONPATH=src python examples/torch_serve_lm.py --arch h2o-danube-1.8b \\
      --prompt-len 64 --gen 32 [--device cpu]

The twin of ``examples/serve_lm.py``. It runs on the card by default;
``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.sharding.rules import ShardingContext  # noqa: E402


def serve_config(arch: str, prompt_len: int):
    """The example's reduced config of ``arch``."""
    return reduced(get_config(arch), n_layers=2, d_model=128, vocab=512,
                   seq=prompt_len)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg, batch: int = 4, prompt_len: int = 64, gen: int = 32,
        device: str = "cuda", params=None) -> dict:
    """Prefill ``batch`` random prompts (numpy seed 0) and greedy-decode
    ``gen`` tokens. ``params`` defaults to a tree drawn from seed 0 (pass
    one to serve given weights, e.g. ``convert.lm_params_from_numpy``).
    Returns the generated tokens (``tokens`` (batch, gen)), the prefill
    ms and the decode ms a token."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode")
    dev = resolve_device(device)
    if params is None:
        params = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ctx = ShardingContext(attn_impl="flash")
    prefill = make_prefill_step(cfg, ctx)
    decode = make_decode_step(cfg, ctx)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
    tokens = torch.as_tensor(prompts, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = logits[:, -1].argmax(-1, keepdim=True)

    out_tokens = [tok[:, 0]]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(params, {"token": tok,
                                         "cache_pos": prompt_len + i}, caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out_tokens.append(tok[:, 0])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return dict(tokens=torch.stack(out_tokens, dim=1).cpu().numpy(),
                prefill_ms=t_prefill * 1e3,
                decode_ms=t_decode / max(gen - 1, 1) * 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch, args.prompt_len)
    out = run(cfg, args.batch, args.prompt_len, args.gen, args.device)
    gen = out["tokens"]
    print(f"arch={cfg.name} prefill({args.prompt_len} tok x "
          f"{args.batch}): {out['prefill_ms']:.1f} ms (incl. the kernels' "
          "first load)")
    print(f"decode: {args.gen - 1} steps, {out['decode_ms']:.2f} ms/token "
          f"(batch {args.batch})")
    print(f"sample continuation (seq 0): {gen[0][:16].tolist()}")
    assert np.all(gen >= 0) and np.all(gen < cfg.vocab)
    print("OK")
    return out


if __name__ == "__main__":
    main()
