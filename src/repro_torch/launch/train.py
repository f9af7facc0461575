"""Training launcher of the port (``repro.launch.train``'s flags, plus
``--torch-device``), on the card unless ``--torch-device cpu`` is given.

  # a short run of a reduced config on the CPU (the kernels' plain
  # versions)
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 20 --batch 8 --seq 128 --torch-device cpu

  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --smoke --steps 50 [--opt-dtype int8] [--microbatches 2]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig
from repro_torch.device import device_name, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Train a zoo LM on synthetic tokens through "
                    "repro_torch.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Returns the run's history (one record per logged step)."""
    args = parse_args(argv)
    device = resolve_device(args.torch_device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    tcfg = TrainConfig(
        steps=args.steps, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, microbatches=args.microbatches,
        opt=AdamWConfig(state_dtype=args.opt_dtype))
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={device_name(device)}")
    _, _, history = train(model, data_cfg, tcfg)
    if history:
        print(f"[train] first loss {history[0]['loss']:.4f} → "
              f"last loss {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
