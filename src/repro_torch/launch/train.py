"""Training launcher: the WANify Trainer on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --steps 6 --batch 4 --seq 1024 --sync psum          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
      --steps 6 --batch 4 --seq 1024 --sync psum          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
      --steps 6 --batch 4 --seq 1024 --sync psum          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --reduced --device cpu                             # small, on the host
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --reduced --pods 4 --skew 0.5 --compress --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-1b-a400m --reduced --device cpu   # the MoE

The reference's flags; one card holds every pod, so `--data` and
`--model` (the reference's mesh axes) above 1 raise. `--arch` takes the
ported ids, and each trains: the dense family (SwiGLU's gate and flash
attention with their backward kernels), the ssm family
(`mamba2-2.7b`: the SSD chunk, SiLU and the gated norm's gate with
theirs), the hybrid family (`zamba2-2.7b`: the ssm family's kernels
in its Mamba-2 layers and the dense family's in its one shared
attention + MLP block, whose gradient sums its applications') and the
MoE family (`granite-moe-1b-a400m`: the routing slots, the dispatch
and the combine with their backward kernels, the experts' gate, flash
attention).
"""
import argparse
from typing import Optional, Sequence

from repro_torch.configs import PORTED, get_config
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core.predictor import BwPredictor
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import check_family
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.wan.dataset import train_default_forest
from repro_torch.wan.simulator import WanSimulator


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Parse the arguments, build the Trainer and run it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=PORTED, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--sync", default="wanify", choices=["wanify", "psum"])
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--skew", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise ValueError("--data and --model above 1 shard over several "
                         "cards; the port runs on one (every pod on it)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    check_family(cfg)
    dev = resolve_device(args.device)
    dcfg = DataConfig(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                      n_pods=max(args.pods, 1), skew=args.skew,
                      seed=args.seed)
    sim = pred = None
    if args.pods > 1 and args.sync == "wanify":
        print("[train] training WAN prediction model ...")
        rf, acc, r2 = train_default_forest(n_samples=150, n_trees=40)
        print(f"[train] forest train_acc={acc:.3f} holdout_r2={r2:.3f}")
        sim, pred = WanSimulator(seed=args.seed), BwPredictor(rf, device=dev)
    tr = Trainer(cfg, max(args.pods, 1), dcfg,
                 LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                            sync=args.sync, compress=args.compress),
                 opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
                 sim=sim, predictor=pred, device=dev)
    if tr.plan:
        print(f"[train] WanPlan conns={tr.plan.conns} "
              f"bits={tr.plan.compress_bits}")
    tr.run(args.seed)
    for h in tr.history[:: max(1, len(tr.history) // 20)]:
        print(f"[train] step {h['step']:5d} loss {h['loss']:.4f} "
              f"({h['time']:.2f}s)")
    print(f"[train] events: {tr.events}")


if __name__ == "__main__":
    main()
