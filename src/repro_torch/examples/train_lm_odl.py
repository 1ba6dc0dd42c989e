"""End-to-end driver: train an LM with the fused ODL head, on the port
(counterpart of the JAX package's ``examples/train_lm_odl.py``).

Presets:
  smoke (default) — 2-layer qwen3-family, 139,648 params, 50 steps.
  100m            — 12 x d768 qwen3-family (~124 M params incl. embeddings),
                    300 steps at batch 8 x seq 128.

The train step fuses the paper's technique: every step the OS-ELM head
RLS-trains on pooled hidden features, with P1P2 auto-pruning deciding which
rows may skip their teacher label.  Watch odl_q (query fraction) fall as
theta relaxes once the head has trained on max(N, 288) rows.

Run:  python -m repro_torch.examples.train_lm_odl [--preset 100m] [--device cpu]
          [--ckpt-dir <dir>]

Without ``--ckpt-dir`` the run keeps no checkpoints; with one, a later run
with the same directory resumes from its newest checkpoint.
"""

import argparse

from repro_torch import configs, resolve_device
from repro_torch.launch.train import train
from repro_torch.models import layers
from repro_torch.models import model as model_lib


def preset_cfg(preset: str) -> dict:
    smoke = configs.get_config("qwen3-4b", "smoke")
    if preset == "smoke":
        return dict(steps=50, batch=8, seq=64, cfg=smoke)
    if preset == "100m":
        arch = smoke.replace(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab_size=32_000,
        )
        return dict(steps=300, batch=8, seq=128, cfg=arch)
    raise ValueError(preset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint and resume here (default: no checkpoints)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    p = preset_cfg(args.preset)
    steps = args.steps or p["steps"]
    n_params = layers.count_params(model_lib.build_schema(p["cfg"]))
    print(f"preset={args.preset}: {n_params:,} params, {steps} steps")
    _, losses = train(
        "qwen3-4b", "smoke", steps=steps, batch=p["batch"], seq=p["seq"],
        ckpt_dir=args.ckpt_dir, ckpt_every=50, device=device, cfg=p["cfg"],
    )
    if not losses:
        print(f"no steps to run: {args.ckpt_dir} already holds step {steps} or later")
        return
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'flat'})")


if __name__ == "__main__":
    main()
