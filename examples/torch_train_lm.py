"""Train a small qwen-family model with the PyTorch port's substrate:
deterministic prefetching pipeline, AdamW + cosine schedule, async
step-atomic checkpoints (kill it mid-run and rerun with --restore to
watch it resume); the counterpart of examples/train_lm.py.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
      [--device cpu]

Runs on the CUDA card unless given --device cpu. Checkpoints go under
build/ in the repository.
"""
import argparse
import pathlib

from repro_torch.launch.train import train

CKPT = pathlib.Path(__file__).resolve().parents[1] / "build" \
    / "torch_lm_ckpt"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(CKPT))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    _, losses = train("qwen1.5-4b", smoke=True, steps=args.steps,
                      global_batch=4, seq_len=args.seq_len,
                      ckpt_dir=args.ckpt_dir, ckpt_every=50,
                      restore=args.restore, grad_compress=args.grad_compress,
                      log_every=20, device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")


if __name__ == "__main__":
    main()
