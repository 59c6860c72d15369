"""Throughput smoke script (reference ``fetalsyngen/test_dl.py``): time a full
pass over the dataset. The reference forks spawn DataLoader workers around one
GPU; here samples are generated on-device with prefetching, so this script
times the direct sequential path and the batched device path.

    python -m fetalsyngen_tpu.test_dl --config configs/test.yaml
"""

from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default="configs/test.yaml")
    ap.add_argument("--bids_path", type=str, default=None)
    ap.add_argument("--seed_path", type=str, default=None)
    ap.add_argument("--shape", type=int, default=None,
                    help="override the generator grid edge (e.g. 64 for smoke runs)")
    ap.add_argument("--epochs", type=int, default=1)
    args = ap.parse_args()

    from fetalsyngen_tpu.compile_cache import enable_compile_cache
    from fetalsyngen_tpu.config import instantiate, load_yaml, resolve_interpolations

    enable_compile_cache()

    cfg = resolve_interpolations(load_yaml(args.config))
    cfg = cfg.get("dataset", cfg)
    if args.bids_path:
        cfg["bids_path"] = args.bids_path
    if args.seed_path:
        cfg["seed_path"] = args.seed_path
    gen_cfg = cfg.pop("generator")
    if args.shape:
        gen_cfg["shape"] = [args.shape] * 3
        gen_cfg.get("spatial_deform", {})["size"] = [args.shape] * 3
    generator = instantiate(gen_cfg)
    dataset = instantiate(cfg, generator=generator)

    # warmup (compile)
    _ = dataset[0]

    start = time.time()
    n = 0
    for _ in range(args.epochs):
        for i in range(len(dataset)):
            _ = dataset[i]
            n += 1
    dt = time.time() - start
    print(f"Time taken for dataloader: {dt:.2f} seconds ({n / dt:.2f} samples/s)")


if __name__ == "__main__":
    main()
