"""Batched serving of reduced assigned architectures on the PyTorch/CUDA
port (prefill + decode through the ring-buffer KV, latent and SSM caches,
and the cross caches of whisper and llama-3.2-vision; counterpart of
``examples/serve_batched.py``).

    PYTHONPATH=src python examples/torch_serve_batched.py \
        --archs qwen2-0.5b,whisper-medium,llama-3.2-vision-11b --gen 16 \
        [--device cpu]
"""
import argparse
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen2-0.5b,chatglm3-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = ["--device", args.device] if args.device else []
    for arch in args.archs.split(","):
        print(f"=== {arch} ===", flush=True)
        subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
             "--batch", str(args.batch),
             "--prompt-len", str(args.prompt_len),
             "--gen", str(args.gen), *device],
            check=True)


if __name__ == "__main__":
    main()
